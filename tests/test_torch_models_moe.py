"""Port parity: the MoE layer (``models/layers/moe.py``) and the MoE
transformer (olmoe-1b-7b, deepseek-moe-16b) against the JAX package on the
same weights.

Weights are the reference's own init carried by
``interop.model_from_reference_params`` (the layer's by numpy); inputs
are numpy draws from a seed; float32 on the CPU, held at atol = rtol =
2e-4.  The routing is discrete, so every test asserts that its inputs hold
no near-tie: consecutive router probabilities among each token's top k + 1
lie at least ``MARGIN`` apart (float32 noise in the router is ~1e-7),
and the selected experts are then equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.factory import build_model as jbuild
from repro.models.layers import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models.layers import moe as tmoe

TOL = dict(atol=2e-4, rtol=2e-4)
MARGIN = 1e-5


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _close(port, ref, **tol):
    if isinstance(port, torch.Tensor):
        port = port.detach()
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(ref, np.float32), **(tol or TOL))


def routing_margin(probs: torch.Tensor, k: int) -> float:
    """The smallest gap between consecutive sorted probabilities among each
    token's top k + 1 (the order of the top k fixes the buffer positions,
    the (k+1)-th the choice)."""
    top = torch.sort(probs.reshape(-1, probs.shape[-1]), dim=-1,
                     descending=True).values[:, : k + 1]
    return float((top[:, :-1] - top[:, 1:]).min())


def _dims_pair(shared, cf=1.25):
    kw = dict(d_model=64, num_experts=8, experts_per_token=2, d_expert=32,
              num_shared_experts=shared, capacity_factor=cf)
    return jmoe.MoEDims(**kw), tmoe.MoEDims(**kw)


@pytest.mark.parametrize("shared,cf", [(0, 1.25), (2, 1.25), (0, 0.25), (1, 0.25)])
def test_moe_apply_matches_reference(shared, cf):
    """Output, the three aux entries and the selected experts; at
    capacity factor 0.25 tokens drop (the dropped fraction is > 0)."""
    jdims, tdims = _dims_pair(shared, cf)
    p = jmoe.moe_init(jax.random.PRNGKey(3), jdims, jnp.float32)
    x = np.random.default_rng(4).standard_normal((2, 48, 64)).astype(np.float32)
    ref, aux_ref = jax.jit(jmoe.moe_apply, static_argnums=2)(p, jnp.asarray(x), jdims)
    out, aux = tmoe.moe_apply(_t(p), torch.from_numpy(x), tdims)
    probs, _, idx = tmoe.moe_route(_t(p), torch.from_numpy(x), tdims)
    margin = routing_margin(probs, tdims.experts_per_token)
    assert margin > MARGIN, margin
    ref_probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", jnp.asarray(x), p["router"]))
    _, ref_idx = jax.lax.top_k(ref_probs, tdims.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    _close(out, ref)
    for key in ("moe_aux_loss", "moe_dropped_frac", "moe_expert_load"):
        _close(aux[key], aux_ref[key])
    if cf < 1:
        assert float(aux["moe_dropped_frac"]) > 0.1, float(aux["moe_dropped_frac"])


def test_moe_capacity_and_tie_order_match_reference():
    """``_capacity`` over sequence lengths and factors (8 at decode); equal
    probabilities keep the lower expert first, as ``lax.top_k`` does."""
    for s in (1, 7, 48, 128, 4096):
        for cf in (0.25, 1.0, 1.25, 2.0):
            for e, k in ((4, 2), (8, 2), (16, 2), (64, 6), (64, 8)):
                kw = dict(d_model=8, num_experts=e, experts_per_token=k,
                          d_expert=8, capacity_factor=cf)
                assert tmoe._capacity(s, tmoe.MoEDims(**kw)) == \
                    jmoe._capacity(s, jmoe.MoEDims(**kw)), (s, cf, e, k)
    assert tmoe._capacity(1, tmoe.MoEDims(8, 64, 6, 8)) == 8
    # a router whose logits tie: every token sees experts 1, 3 and 5 equal
    router = np.zeros((4, 8), np.float32)
    router[0, [1, 3, 5]] = 1.0
    x = np.ones((1, 3, 4), np.float32)
    dims = tmoe.MoEDims(4, 8, 2, 4)
    _, gates, idx = tmoe.moe_route({"router": torch.from_numpy(router)},
                                   torch.from_numpy(x), dims)
    _, ref_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ router), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert idx[0, 0].tolist() == [1, 3]
    _close(gates, np.full((1, 3, 2), 0.5))


def test_moe_backward_is_deterministic_and_drops_get_no_gradient():
    """Two backward passes under ``use_deterministic_algorithms`` give the
    same bits; without shared experts a token whose choices all drop gets
    no gradient (its output is zero whatever its gates)."""
    _, tdims = _dims_pair(0, 0.25)
    p = {k: v.requires_grad_(True) for k, v in _t(jmoe.moe_init(
        jax.random.PRNGKey(5), _dims_pair(0, 0.25)[0], jnp.float32)).items()}
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 48, 64)).astype(np.float32)).requires_grad_(True)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        grads = []
        for _ in range(2):
            out, _ = tmoe.moe_apply(p, x, tdims)
            grads.append(torch.autograd.grad(out.square().sum(), [x, *p.values()]))
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    _, _, idx = tmoe.moe_route(p, x, tdims)
    flat = idx.reshape(2, -1)
    onehot = torch.nn.functional.one_hot(flat, tdims.num_experts)
    pos = ((onehot.cumsum(1) - onehot) * onehot).sum(-1)
    kept = (pos < tmoe._capacity(48, tdims)).reshape(2, 48, 2)
    gx = grads[0][0]
    assert (~kept.any(-1)).any()
    assert float(gx[~kept.any(-1)].abs().max()) == 0.0
    assert float(gx[kept.all(-1)].abs().min()) > 0.0


# -- whole models ---------------------------------------------------------------

MODELS = {}


def _models(arch):
    if arch not in MODELS:
        jcfg = jconfigs.reduced(jconfigs.get_arch(arch))
        jm = jbuild(jcfg, dtype=jnp.float32)
        params = jm.init(jax.random.PRNGKey(0))
        tcfg = tconfigs.reduced(tconfigs.get_arch(arch))
        tm = interop.model_from_reference_params(tcfg, _np(params), device="cpu")
        MODELS[arch] = (jcfg, jm, params, tcfg, tm)
    return MODELS[arch]


class RouteLog:
    """Records every router call's probabilities (through ``moe_route``)."""

    def __init__(self, monkeypatch):
        self.probs, route = [], tmoe.moe_route

        def recording(params, x, dims):
            out = route(params, x, dims)
            self.probs.append((out[0].detach(), dims.experts_per_token))
            return out

        monkeypatch.setattr(tmoe, "moe_route", recording)

    def margin(self) -> float:
        return min(routing_margin(p, k) for p, k in self.probs)


def run_model_parity(arch, use_kernels, tokens, labels, monkeypatch, extra=None):
    """apply, loss with its aux, and 20 decode steps through a 16-slot cache
    against the reference (``use_kernels`` on both sides); returns the
    routing margin seen by the port."""
    jcfg, jm, params, tcfg, tm = _models(arch)
    jm_k = jbuild(dataclasses.replace(jcfg, use_kernels=use_kernels),
                  dtype=jnp.float32)
    tm.cfg = dataclasses.replace(tcfg, use_kernels=use_kernels)
    log = RouteLog(monkeypatch)
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32),
              "labels": jnp.asarray(labels, jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    for k, v in (extra or {}).items():
        jbatch[k], tbatch[k] = jnp.asarray(v), torch.from_numpy(v)
    _close(tm.apply(tbatch), jax.jit(jm_k.apply)(params, jbatch))
    (l_ref, aux_ref), (l_out, aux_out) = jax.jit(jm_k.loss)(params, jbatch), tm.loss(tbatch)
    _close(l_out, l_ref)
    assert set(aux_out) == set(aux_ref)
    for k in aux_ref:
        _close(aux_out[k], aux_ref[k])
    j_decode = jax.jit(jm.decode_step)
    jc, tc = jm.init_cache(tokens.shape[0], 16), tm.init_cache(tokens.shape[0], 16)
    for pos in range(20):
        tok = tokens[:, pos:pos + 1]
        l_ref, jc = j_decode(params, jnp.asarray(tok, jnp.int32), jc,
                             jnp.asarray(pos, jnp.int32))
        l_out, tc = tm.decode_step(torch.from_numpy(tok), tc, pos)
        assert l_out.dtype == torch.float32 and l_out.shape == (tokens.shape[0],
                                                                jcfg.vocab_size)
        _close(l_out, l_ref)
    tm.cfg = tcfg
    return log.margin()


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_model_apply_loss_decode_match_reference(arch, use_kernels, monkeypatch):
    """``use_kernels`` changes nothing on this family, in either package
    (its attention is the einsum path)."""
    jcfg = _models(arch)[0]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64))
    labels = rng.integers(0, jcfg.vocab_size, (2, 64))
    margin = run_model_parity(arch, use_kernels, tokens, labels, monkeypatch)
    assert margin > MARGIN, margin
