"""Port parity: the LLM slice — configs, layers and whole models — against
the JAX package on the same weights.

Weights are the reference's own random init (``Model.init`` /
the layer ``*_init`` functions), carried across as numpy arrays
(``interop.model_from_reference_params`` for whole models); inputs are
numpy draws from a seed.  Everything runs in float32 on the CPU and is
held at atol = rtol = 2e-4, as ``tests/test_perf_paths.py`` holds the
reference's kernel path against its einsum path.  With ``use_kernels``
the port's CPU path runs each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.factory import build_model as jbuild
from repro.models.layers import attention as jattn
from repro.models.layers import embedding as jemb
from repro.models.layers import mamba2 as jmamba
from repro.models.layers import mlp as jmlp
from repro.models.layers import norms as jnorms
from repro.models.layers import rotary as jrot
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models.base import leaf_shape, param_tree
from repro_torch.models.factory import build_model
from repro_torch.models.layers import attention as tattn
from repro_torch.models.layers import embedding as temb
from repro_torch.models.layers import mamba2 as tmamba
from repro_torch.models.layers import mlp as tmlp
from repro_torch.models.layers import norms as tnorms
from repro_torch.models.layers import rotary as trot
from repro_torch.optim.base import leaves

TOL = dict(atol=2e-4, rtol=2e-4)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    """numpy pytree -> torch pytree (same dtypes)."""
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _close(port, ref, **tol):
    if isinstance(port, torch.Tensor):
        port = port.detach()  # loss runs under grad
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


# -- configs ------------------------------------------------------------------


def test_config_registry_and_reduced_match_reference():
    assert list(tconfigs.ARCHITECTURES) == list(jconfigs.ARCHITECTURES)
    for name, jcfg in jconfigs.ARCHITECTURES.items():
        tcfg = tconfigs.get_arch(name)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
        assert dataclasses.asdict(tconfigs.reduced(tcfg)) == dataclasses.asdict(
            jconfigs.reduced(jcfg))
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
        for shape in jconfigs.INPUT_SHAPES:
            tshape = tconfigs.get_shape(shape.name)
            assert dataclasses.asdict(tconfigs.arch_for_shape(tcfg, tshape)) == \
                dataclasses.asdict(jconfigs.arch_for_shape(jcfg, shape))
    with pytest.raises(KeyError):
        tconfigs.get_arch("gpt-5")


def _ref_paths(params) -> dict:
    """``{"a/0/b": (shape, dtype name)}`` in ``jax.tree_util`` order."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


@pytest.mark.parametrize("arch", list(jconfigs.ARCHITECTURES))
def test_build_model_builds_every_architecture(arch):
    """Every family builds (reduced, bf16, CPU) with the reference's
    parameter paths, order, shapes and dtypes (the float32 norm scales,
    router and SSM leaves); the reference's weights carry into it and back
    bit for bit."""
    jparams = _np(jbuild(jconfigs.reduced(jconfigs.get_arch(arch)),
                         dtype=jnp.bfloat16).init(jax.random.PRNGKey(0)))
    ref = _ref_paths(jparams)
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    own = param_tree(build_model(tcfg, torch.bfloat16, device="cpu"))
    assert list(own) == list(ref)
    assert {k: (leaf_shape(v), str(leaves({k: v})[0].dtype).split(".")[1])
            for k, v in own.items()} == ref
    tm = interop.model_from_reference_params(tcfg, jparams, device="cpu")
    back = interop.reference_params_of(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        # bfloat16 comes back as the checkpoints' two-byte records
        assert a.dtype == b.dtype or (a.dtype == np.dtype("V2")
                                      and b.dtype.name == "bfloat16")
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))

@pytest.mark.parametrize("arch", list(jconfigs.ARCHITECTURES))
def test_input_specs_match_reference(arch):
    """The dry-run stand-ins of every input shape, for training and decode:
    names, shapes and dtypes (audio's include ``frames``, the vlm's
    ``prefix_embeddings``, in the model dtype)."""
    jm = jbuild(jconfigs.get_arch(arch), dtype=jnp.bfloat16)
    tm = build_model(tconfigs.reduced(tconfigs.get_arch(arch)), torch.bfloat16,
                     device="cpu")
    tm.cfg = tconfigs.get_arch(arch)
    for shape in jconfigs.INPUT_SHAPES:
        tshape = tconfigs.get_shape(shape.name)
        for for_decode in (False, True):
            ref = {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                   for k, v in jm.input_specs(shape, for_decode=for_decode).items()}
            port = {k: (s, str(d).split(".")[1])
                    for k, (s, d) in tm.input_specs(tshape, for_decode=for_decode).items()}
            assert port == ref, (shape.name, for_decode)


# -- layers -------------------------------------------------------------------


def test_rmsnorm_rope_swiglu_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    _close(tnorms.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)),
           jnorms.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)))
    heads = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9))
    _close(trot.apply_rope(torch.from_numpy(heads), torch.from_numpy(pos), 5e5),
           jrot.apply_rope(jnp.asarray(heads), jnp.asarray(pos, jnp.int32), 5e5))
    p = jmlp.swiglu_init(jax.random.PRNGKey(1), 64, 128, jnp.float32)
    _close(tmlp.swiglu(_t(p), torch.from_numpy(x)), jmlp.swiglu(p, jnp.asarray(x)))


def _attn_case(qkv_bias=False, num_kv=2, repeat_kv=False):
    dims_kw = dict(d_model=64, num_heads=4, num_kv_heads=num_kv, head_dim=16,
                   qkv_bias=qkv_bias, repeat_kv=repeat_kv)
    jdims, tdims = jattn.AttnDims(**dims_kw), tattn.AttnDims(**dims_kw)
    p = jattn.attn_init(jax.random.PRNGKey(2), jdims, jnp.float32)
    if qkv_bias:  # the init's biases are zeros: make them count
        for i, name in enumerate(("bq", "bk", "bv")):
            p[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(10 + i), p[name].shape)
    return jdims, tdims, p, _t(p)


@pytest.mark.parametrize(
    "mode,window,use_flash,qkv_bias,repeat_kv",
    [
        ("causal", 0, False, False, False),
        ("causal", 0, True, False, False),
        ("causal", 0, False, True, True),
        ("causal", 24, False, False, False),
        ("causal", 24, True, False, False),
        ("bidir", 0, True, False, False),
        ("prefix", 0, False, False, False),
        ("prefix", 0, True, False, False),  # prefix falls through to einsum
    ],
)
def test_attention_full_matches_reference(mode, window, use_flash, qkv_bias,
                                          repeat_kv):
    jdims, tdims, jp, tp = _attn_case(qkv_bias=qkv_bias, repeat_kv=repeat_kv)
    x = np.random.default_rng(3).standard_normal((2, 70, 64)).astype(np.float32)
    kw = dict(mode=mode, window=window, prefix_len=20 if mode == "prefix" else 0)
    ref = jattn.attention_full(jp, jnp.asarray(x), jdims, use_flash=use_flash, **kw)
    out = tattn.attention_full(tp, torch.from_numpy(x), tdims, use_flash=use_flash,
                               **kw)
    _close(out, ref)
    for m in ("causal", "prefix", "bidir"):
        _close(tattn.make_mask(11, m, window=3, prefix_len=4),
               jattn.make_mask(11, m, window=3, prefix_len=4))


@pytest.mark.parametrize("cache_len", [8, 32])
def test_attention_decode_matches_reference(cache_len):
    """12 positions through a ring buffer of 8 slots wraps it."""
    jdims, tdims, jp, tp = _attn_case()
    xs = np.random.default_rng(4).standard_normal((2, 12, 1, 64)).astype(np.float32)
    jc = jattn.init_kv_cache(2, cache_len, 2, 16, jnp.float32)
    tc = tattn.init_kv_cache(2, cache_len, 2, 16, torch.float32)
    for pos in range(12):
        ref, jc = jattn.attention_decode(jp, jnp.asarray(xs[:, pos]), jc,
                                         jnp.asarray(pos, jnp.int32), jdims)
        out, tc = tattn.attention_decode(tp, torch.from_numpy(xs[:, pos]), tc, pos,
                                         tdims)
        _close(out, ref)
    np.testing.assert_array_equal(tc["slot_pos"].numpy(), np.asarray(jc["slot_pos"]))
    _close(tc["k"], jc["k"])


def _mamba_case():
    kw = dict(d_model=64, d_state=16, num_heads=4, head_dim=32, num_groups=2,
              conv_kernel=4, chunk=16)
    jdims, tdims = jmamba.MambaDims(**kw), tmamba.MambaDims(**kw)
    p = jmamba.mamba_init(jax.random.PRNGKey(6), jdims, jnp.float32)
    return jdims, tdims, p, _t(p)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_apply_matches_reference(use_kernel):
    jdims, tdims, jp, tp = _mamba_case()
    x = np.random.default_rng(7).standard_normal((2, 40, 64)).astype(np.float32)
    ref = jmamba.mamba_apply(jp, jnp.asarray(x), jdims, use_kernel=use_kernel)
    out = tmamba.mamba_apply(tp, torch.from_numpy(x), tdims, use_kernel=use_kernel)
    _close(out, ref)


def test_ssd_chunked_and_reference_match():
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((2, 37, 4, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, 37, 4)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(4) * 0.3).astype(np.float32)
    bs, cs = (rng.standard_normal((2, 37, 2, 16)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((2, 4, 16, 8)).astype(np.float32)
    j = [jnp.asarray(v) for v in (xs, dt, a, bs, cs)]
    t = [torch.from_numpy(v) for v in (xs, dt, a, bs, cs)]
    y_ref, h_ref = jmamba.ssd_chunked(*j, 16, h0=jnp.asarray(h0))
    y, h = tmamba.ssd_chunked(*t, 16, h0=torch.from_numpy(h0))
    _close(y, y_ref)
    _close(h, h_ref)
    y_seq, h_seq = tmamba.ssd_reference(*t, h0=torch.from_numpy(h0))
    _close(y_seq, y_ref)
    _close(h_seq, h_ref)


def test_mamba_decode_matches_reference():
    jdims, tdims, jp, tp = _mamba_case()
    xs = np.random.default_rng(9).standard_normal((2, 6, 1, 64)).astype(np.float32)
    jc = jmamba.init_mamba_cache(2, jdims, jnp.float32)
    tc = tmamba.init_mamba_cache(2, tdims, torch.float32)
    for i in range(6):
        ref, jc = jmamba.mamba_decode(jp, jnp.asarray(xs[:, i]), jc, jdims)
        out, tc = tmamba.mamba_decode(tp, torch.from_numpy(xs[:, i]), tc, tdims)
        _close(out, ref)
    _close(tc["ssm"], jc["ssm"])
    _close(tc["conv"], jc["conv"])


@pytest.mark.parametrize("num_chunks", [1, 4, 5])
def test_chunked_xent_matches_reference(num_chunks):
    rng = np.random.default_rng(10)
    table = (rng.standard_normal((97, 32)) * 0.3).astype(np.float32)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    labels = rng.integers(-1, 97, (2, 20))  # -1 is masked out
    ref = jemb.chunked_softmax_xent(jnp.asarray(table), jnp.asarray(x),
                                    jnp.asarray(labels, jnp.int32), num_chunks)
    out = temb.chunked_softmax_xent(torch.from_numpy(table), torch.from_numpy(x),
                                    torch.from_numpy(labels), num_chunks)
    _close(out, ref)
    _close(temb.unembed_logits({"table": torch.from_numpy(table)},
                               torch.from_numpy(x)),
           jemb.unembed_logits({"table": jnp.asarray(table)}, jnp.asarray(x)))


# -- whole models -------------------------------------------------------------


MODELS = {}


def _models(arch):
    """Reference model and params (reduced, float32), and the port's model on
    the carried weights — built once per arch."""
    if arch not in MODELS:
        jcfg = jconfigs.reduced(jconfigs.get_arch(arch))
        jm = jbuild(jcfg, dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(0))
        if jcfg.qkv_bias:
            attn = params["layers"]["attn"]
            for i, name in enumerate(("bq", "bk", "bv")):
                attn[name] = 0.1 * jax.random.normal(jax.random.PRNGKey(20 + i),
                                                     attn[name].shape)
        tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
        tm = interop.model_from_reference_params(tcfg, _np(params), device="cpu")
        MODELS[arch] = (jcfg, jm, params, tcfg, tm)
    return MODELS[arch]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2.5-32b", "mamba2-370m"])
def test_model_apply_loss_decode_match_reference(arch, use_kernels):
    jcfg, jm, params, tcfg, tm = _models(arch)
    jm_k = jbuild(dataclasses.replace(jcfg, use_kernels=use_kernels),
                  dtype=jnp.float32)
    j_apply, j_loss = jax.jit(jm_k.apply), jax.jit(jm_k.loss)
    j_decode = jax.jit(jm.decode_step)
    tm.cfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 96))
    labels = rng.integers(0, jcfg.vocab_size, (2, 96))
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    _close(tm.apply(tbatch), j_apply(params, jbatch))
    (l_ref, aux_ref), (l_out, aux_out) = j_loss(params, jbatch), tm.loss(tbatch)
    _close(l_out, l_ref)
    _close(aux_out["xent"], aux_ref["xent"])
    # decode: 20 positions through a 16-slot cache (wraps the ring buffer)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    for pos in range(20):
        tok = tokens[:, pos:pos + 1]
        l_ref, jc = j_decode(params, jnp.asarray(tok, jnp.int32), jc,
                             jnp.asarray(pos, jnp.int32))
        l_out, tc = tm.decode_step(torch.from_numpy(tok), tc, pos)
        assert l_out.dtype == torch.float32 and l_out.shape == (2, jcfg.vocab_size)
        _close(l_out, l_ref)


def test_bfloat16_carry_keeps_leaf_dtypes():
    jcfg = jconfigs.reduced(jconfigs.get_arch("mamba2-370m"))
    params = _np(jbuild(jcfg, dtype=jnp.bfloat16).init(jax.random.PRNGKey(3)))
    tm = interop.model_from_reference_params(
        tconfigs.reduced(tconfigs.get_arch("mamba2-370m")), params, device="cpu")
    sd = tm.state_dict()
    assert sd["embedding.table"].dtype == torch.bfloat16
    for name in ("ln.scale", "mixer.a_log", "mixer.d_skip", "mixer.dt_bias"):
        assert sd[f"layers.1.{name}"].dtype == torch.float32, name
    assert sd["layers.0.mixer.in_proj"].dtype == torch.bfloat16
    # bit for bit
    ref = params["layers"]["mixer"]["in_proj"][1].view(np.uint16)
    np.testing.assert_array_equal(
        sd["layers.1.mixer.in_proj"].view(torch.int16).numpy().view(np.uint16), ref)
    # the port's own init gives the same names, shapes and dtypes
    own = build_model(tconfigs.reduced(tconfigs.get_arch("mamba2-370m")),
                      torch.bfloat16, device="cpu").state_dict()
    assert {k: (v.shape, v.dtype) for k, v in own.items()} == \
        {k: (v.shape, v.dtype) for k, v in sd.items()}


def test_weight_carry_raises_on_a_wrong_leaf():
    jcfg, jm, params, tcfg, tm = _models("minitron-8b")
    good = _np(params)

    def edited(fn):
        tree = jax.tree_util.tree_map(lambda a: a, good)
        fn(tree)
        return tree

    cases = {
        "missing": lambda t: t["layers"]["attn"].pop("wo"),
        "extra": lambda t: t["layers"]["attn"].__setitem__("bq", np.zeros((2, 4, 64), np.float32)),
        "shape": lambda t: t["layers"]["mlp"].__setitem__(
            "w_up", t["layers"]["mlp"]["w_up"][:, :, :-1]),
        "layer axis": lambda t: t["layers"]["ln1"].__setitem__(
            "scale", t["layers"]["ln1"]["scale"][0]),
        "dtype": lambda t: t["ln_f"].__setitem__(
            "scale", t["ln_f"]["scale"].astype(np.float16)),
    }
    for what, fn in cases.items():
        with pytest.raises(ValueError):
            interop.model_from_reference_params(tcfg, edited(fn), device="cpu")
    interop.model_from_reference_params(tcfg, good, device="cpu")  # still fine


def _edit(tree, path, fn):
    """A copy of the numpy pytree ``tree`` with ``fn(parent, key)`` applied
    at ``path`` (``a/0/b``)."""
    tree = jax.tree_util.tree_map(lambda a: a, tree)
    *parents, key = path.split("/")
    node = tree
    for p in parents:
        node = node[int(p)] if isinstance(node, list) else node[p]
    fn(node, key)
    return tree


@pytest.mark.parametrize("arch,stacked,listed", [
    ("deepseek-moe-16b", "moe_layers/moe/w_up", "dense_layers/0/mlp/w_up"),
    ("jamba-1.5-large-398b", "periods/mamba/mixer/in_proj", "periods/attn/attn/wq"),
    ("whisper-tiny", "decoder/cross_attn/wk", "dec_pos"),
])
def test_weight_carry_refuses_a_wrong_leaf_in_every_tree(arch, stacked, listed):
    """A list entry (``dense_layers/0``), a stack in a stack (the hybrid's
    ``(P, 7, ...)``) and the encoder-decoder's trees: a missing, extra,
    mis-shaped (also a lost stack axis) or mis-typed leaf is refused."""
    jparams = _np(jbuild(jconfigs.reduced(jconfigs.get_arch(arch)),
                         dtype=jnp.float32).init(jax.random.PRNGKey(0)))
    tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
    cases = {
        "missing": (listed, lambda node, k: node.pop(k)),
        "extra": (stacked, lambda node, k: node.__setitem__(k + "_x", node[k])),
        "shape": (stacked, lambda node, k: node.__setitem__(k, node[k][..., :-1])),
        "stack axis": (stacked, lambda node, k: node.__setitem__(k, node[k][0])),
        "dtype": (listed, lambda node, k: node.__setitem__(
            k, node[k].astype(np.float16))),
    }
    for what, (path, fn) in cases.items():
        with pytest.raises(ValueError):
            interop.model_from_reference_params(tcfg, _edit(jparams, path, fn),
                                                device="cpu")
    interop.model_from_reference_params(tcfg, jparams, device="cpu")  # still fine
