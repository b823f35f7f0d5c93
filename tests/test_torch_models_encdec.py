"""Port parity: the encoder-decoder audio backbone (whisper-tiny) and its
layers — LayerNorm, the GELU MLP, cross-attention — against the JAX
package on the same weights.

Weights are the reference's own init carried by
``interop.model_from_reference_params`` (the layers' by numpy); inputs
are numpy draws from a seed; float32 on the CPU, held at atol = rtol =
2e-4.  The reference's init gives zero biases: the layer tests set them
to draws, so the biases count.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import encdec as jencdec
from repro.models.factory import build_model as jbuild
from repro.models.layers import attention as jattn
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import train as ttrain
from repro_torch.models import encdec as tencdec
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from test_torch_models_moe import _close, _np, _t

ARCH = "whisper-tiny"


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _with_biases(p, seed):
    """``p`` with every bias (``b*``) replaced by a draw."""
    rng = np.random.default_rng(seed)
    return {k: (0.1 * rng.standard_normal(np.shape(v))).astype(np.float32)
            if k.startswith("b") else np.asarray(v) for k, v in p.items()}


def test_layernorm_and_gelu_mlp_match_reference():
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 9, 64))).astype(np.float32)
    ln = {"scale": rng.standard_normal(64).astype(np.float32),
          "bias": rng.standard_normal(64).astype(np.float32)}
    _close(tnorms.layernorm(_t(ln), torch.from_numpy(x)),
           jnorms.layernorm(ln, jnp.asarray(x)))
    # the population variance, eps 1e-5, float32 math cast back
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out = tnorms.layernorm(tnorms.layernorm_init(64), xb)
    assert out.dtype == torch.bfloat16
    _close(out.float(), jnorms.layernorm(jnorms.layernorm_init(64),
                                 jnp.asarray(x).astype(jnp.bfloat16)), atol=2e-2,
           rtol=2e-2)
    p = _with_biases(jmlp.gelu_mlp_init(jax.random.PRNGKey(1), 64, 128, jnp.float32), 2)
    _close(tmlp.gelu_mlp(_t(p), torch.from_numpy(x)), jmlp.gelu_mlp(p, jnp.asarray(x)))
    # jax.nn.gelu's tanh form, not the erf form (~1e-3 apart)
    h = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(torch.nn.functional.gelu(h, approximate="tanh").numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))),
                               atol=1e-6)


@pytest.mark.parametrize("num_kv", [4, 2])
def test_cross_attention_matches_reference(num_kv):
    kw = dict(d_model=64, num_heads=4, num_kv_heads=num_kv, head_dim=16,
              qkv_bias=True, use_rope=False)
    jdims, tdims = jattn.AttnDims(**kw), tattn.AttnDims(**kw)
    p = _with_biases(jattn.cross_attn_init(jax.random.PRNGKey(3), jdims, jnp.float32), 4)
    rng = np.random.default_rng(5)
    memory = rng.standard_normal((2, 30, 64)).astype(np.float32)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    kv_ref = jattn.precompute_cross_kv(p, jnp.asarray(memory), jdims)
    kv = tattn.precompute_cross_kv(_t(p), torch.from_numpy(memory), tdims)
    for k in ("k", "v"):
        assert kv[k].shape == (2, 30, num_kv, 16)
        _close(kv[k], kv_ref[k])
    _close(tattn.cross_attention(_t(p), torch.from_numpy(x), kv, tdims),
           jattn.cross_attention(p, jnp.asarray(x), kv_ref, jdims))


def test_sinusoid_matches_reference():
    """At whisper's 1500 frames: float32 ``exp`` differs by an ulp between
    XLA and torch, which positions near 1500 carry to ~1e-4 in ``sin``."""
    _close(tencdec.sinusoid(1500, 384), jencdec._sinusoid(1500, 384))


MODELS = {}


def _models():
    if not MODELS:
        jcfg = jconfigs.reduced(jconfigs.get_arch(ARCH))
        jm = jbuild(jcfg, dtype=jnp.float32)
        params = _np(jm.init(jax.random.PRNGKey(0)))
        # the init's biases and LayerNorm shifts are zeros: make them count
        rng = np.random.default_rng(6)
        params = jax.tree_util.tree_map_with_path(
            lambda path, v: (0.05 * rng.standard_normal(v.shape)).astype(v.dtype)
            if str(getattr(path[-1], "key", "")) in ("bq", "bk", "bv", "b_in", "b_out",
                                                     "bias") else v, params)
        tcfg = tconfigs.reduced(tconfigs.get_arch(ARCH))
        tm = interop.model_from_reference_params(tcfg, params, device="cpu")
        MODELS.update(jcfg=jcfg, jm=jm, params=params, tcfg=tcfg, tm=tm)
    return MODELS


@pytest.mark.parametrize("cross", ["encoder", "zeros"])
def test_whisper_apply_loss_decode_match_reference(cross):
    """apply and loss on (frames, tokens); 20 decode steps through a
    16-slot self-attention cache with the cross K/V of the encoder's output
    (``init_cache`` with frames, equal to ``precompute_cross_kv`` on
    ``encode``) or zeros (what ``ServeEngine`` passes)."""
    m = _models()
    jcfg, jm, params, tm = m["jcfg"], m["jm"], m["params"], m["tm"]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 48))
    labels = rng.integers(0, jcfg.vocab_size, (2, 48))
    frames = rng.standard_normal((2, jcfg.encoder_len, jcfg.d_model)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32), "frames": jnp.asarray(frames)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
              "frames": torch.from_numpy(frames)}
    _close(tm.apply(tbatch), jax.jit(jm.apply)(params, jbatch))
    (l_ref, aux_ref), (l_out, aux_out) = jax.jit(jm.loss)(params, jbatch), tm.loss(tbatch)
    _close(l_out, l_ref)
    assert set(aux_out) == set(aux_ref) == {"xent"}
    if cross == "encoder":
        jc = jm.init_cache(2, 16, params, jbatch["frames"])
        tc = tm.init_cache(2, 16, frames=tbatch["frames"])
        with torch.no_grad():
            memory = tm.encode(tbatch["frames"])
            for layer, kv in zip(tm.decoder, tc["cross"]):
                want = tattn.precompute_cross_kv(layer["cross_attn"], memory, tm.dims)
                assert torch.equal(kv["k"], want["k"]) and torch.equal(kv["v"], want["v"])
    else:
        jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
        assert all(float(kv["k"].abs().max()) == 0 for kv in tc["cross"])
    for i, kv in enumerate(tc["cross"]):
        _close(kv["k"], jc["cross"]["k"][i])
        _close(kv["v"], jc["cross"]["v"][i])
    j_decode = jax.jit(jm.decode_step)
    for pos in range(20):
        tok = tokens[:, pos:pos + 1]
        l_ref, jc = j_decode(params, jnp.asarray(tok, jnp.int32), jc,
                             jnp.asarray(pos, jnp.int32))
        l_out, tc = tm.decode_step(torch.from_numpy(tok), tc, pos)
        assert l_out.dtype == torch.float32 and l_out.shape == (2, jcfg.vocab_size)
        _close(l_out, l_ref)


def test_decoder_positions_wrap_at_8192():
    """Position 8192 + p reads row p of ``dec_pos`` at decode, as the
    reference's ``pos % 8192`` does."""
    m = _models()
    tm = m["tm"]
    tok = torch.tensor([[3], [5]])
    a, _ = tm.decode_step(tok, tm.init_cache(2, 4), 2)
    c = tm.init_cache(2, 4)
    c["self"] = [dict(layer, slot_pos=torch.full_like(layer["slot_pos"], -1))
                 for layer in c["self"]]
    b, _ = tm.decode_step(tok, c, 8192 + 2)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_training_whisper_fails_as_the_reference_does():
    """The CLIs' batches have no ``frames``: the reference raises a
    ``KeyError`` inside its loss, the port the same with the reason."""
    kw = dict(graph_kind="ring", n_silos=4, steps=1, batch_size=1, seq_len=16,
              log_every=0)
    with pytest.raises(KeyError):
        jtrain.run_training(jconfigs.reduced(jconfigs.get_arch(ARCH)), **kw)
    with pytest.raises(KeyError, match="frames"):
        ttrain.run_training(tconfigs.reduced(tconfigs.get_arch(ARCH)), device="cpu",
                            **kw)


def test_whisper_gradients_match_reference():
    """Every gradient leaf of the loss (the decoder's layers checkpointed
    with the encoder's memory reaching them from outside) against
    ``jax.grad`` of the reference's, at rtol 1e-4 / atol 1e-4 of the
    leaf's largest entry, as ``test_torch_llm_train`` holds the others.  A
    key bias shifts every score of a query alike, which the softmax
    cancels: its gradient is zero, rounding noise in both packages, and is
    held below 1e-6 of the largest gradient."""
    from repro.utils.checkpoint import flatten_with_paths as jflat
    from repro_torch.models.base import param_tree
    from repro_torch.optim.base import leaves, unflatten
    from repro_torch.utils.checkpoint import flatten_with_paths as tflat

    m = _models()
    jcfg, jm, params, tm = m["jcfg"], m["jm"], m["params"], m["tm"]
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32),
             "labels": rng.integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32),
             "frames": rng.standard_normal((2, jcfg.encoder_len, jcfg.d_model)
                                           ).astype(np.float32)}
    g_ref = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    tree = param_tree(tm)
    loss, _ = tm.loss({k: torch.from_numpy(v) for k, v in batch.items()})
    got = tflat(unflatten(tree, torch.autograd.grad(loss, leaves(tree))))
    want = jflat(g_ref)[0]
    assert list(got) == list(want)
    g_max = max(float(np.abs(np.asarray(r)).max()) for r in want.values())
    for k, r in want.items():
        r = np.asarray(r)
        if k.endswith("attn/bk"):
            assert max(float(np.abs(r).max()), float(np.abs(got[k]).max())) < 1e-6 * g_max
            continue
        np.testing.assert_allclose(got[k], r, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(r).max()), err_msg=k)
