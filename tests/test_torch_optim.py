"""Port parity: the optimizer library (``repro_torch.optim``) against the JAX
package's ``repro.optim`` on the same numpy-seeded parameters and
gradients, over several steps.

The parameters are a reduced mamba2-370m's reference pytree: stacked
``(L, ...)`` layer leaves, which the port holds as tuples of its per-layer
tensors (``repro_torch.models.base``).  Updates and every optimizer-state
leaf are compared under the reference's checkpoint key paths (the port's
``utils.checkpoint.flatten_with_paths`` stacks its per-layer leaves, so
the keys and shapes must agree too), at ``rtol=2e-6`` for the elementwise
transformations and ``rtol=1e-5`` where a reduction (adafactor's means, the
global norm) runs in another order; ``atol`` is ``rtol·lr`` for updates and
parameters (an entry whose update cancels to ~0 is held at the update's
scale) and 1e-9 for the state.  Adam's first step
``-lr·m̂/(√v̂+eps)`` is about ``-lr·sign(g)``, so an entry whose gradient is
within rounding of 0 may flip by 2·lr: step-1 updates are compared where
``|g| > 1e-6·max|g|`` and the rest is counted (3 of 966,112 entries on
these draws; the test requires fewer than 10).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.models.factory import build_model as jbuild
from repro.utils.checkpoint import flatten_with_paths as jflat
from repro_torch import optim as topt
from repro_torch.configs import get_arch as tget_arch, reduced as treduced
from repro_torch.models.base import leaf_shape, stack_axes, stack_paths, tree_of
from repro_torch.models.factory import build_model as tbuild
from repro_torch.utils.checkpoint import flatten_with_paths as tflat

STEPS = 4
LR = 1e-2


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def case():
    """Reference params (numpy pytree) and STEPS gradient pytrees."""
    cfg = jreduced(jget_arch("mamba2-370m"))
    params = jax.tree_util.tree_map(
        np.asarray, jbuild(cfg, dtype=jnp.float32).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32), params)
        for _ in range(STEPS)]
    return params, grads


@functools.lru_cache
def _stacks(arch, **replace):
    """The stack paths of the port's reduced ``arch``."""
    cfg = dataclasses.replace(treduced(tget_arch(arch)), **replace)
    return stack_paths(tbuild(cfg, torch.float32, device="cpu"))


def _port_tree(ref_tree, arch="mamba2-370m", **replace):
    """The reference's nested dict of stacked arrays (of the reduced
    ``arch``) -> the port's tree (a stacked leaf split per layer; the
    hybrid's ``periods/mamba/...`` per period and per sublayer)."""
    stacks = _stacks(arch, **replace)
    named = {}
    for path, arr in jflat(ref_tree)[0].items():
        parts, axes = path.split("/"), stack_axes(path, stacks)
        for idx in np.ndindex(*arr.shape[:len(axes)]):
            names = list(parts)
            for pos, i in reversed(list(zip(axes, idx))):
                names.insert(pos + 1, str(i))
            named[".".join(names)] = torch.from_numpy(np.array(arr[idx]))
    return tree_of(named, stacks)


def _same(port, ref, rtol, atol=1e-9, where=""):
    tp, tr = tflat(port), jflat(ref)[0]
    assert sorted(tp) == sorted(tr), where
    for k in tr:
        np.testing.assert_allclose(tp[k], np.asarray(tr[k]), rtol=rtol,
                                   atol=atol, err_msg=f"{where} {k}")


TRANSFORMS = {
    "sgd": (lambda m: m.sgd(LR), 2e-6),
    "sgd_schedule": (lambda m: m.sgd(m.cosine_decay(LR, 10)), 2e-6),
    "momentum": (lambda m: m.momentum(LR, 0.9), 2e-6),
    "nesterov": (lambda m: m.momentum(LR, 0.9, nesterov=True), 2e-6),
    "adam": (lambda m: m.adam(LR), 2e-6),
    "adamw_schedule": (lambda m: m.adamw(m.warmup_cosine(LR, 2, 10),
                                         weight_decay=0.1), 2e-6),
    "adafactor": (lambda m: m.adafactor(LR), 1e-5),
    "chain_clip_adamw": (lambda m: m.chain(m.clip_by_global_norm(0.5),
                                           m.adamw(LR)), 1e-5),
    "chain_wd_scale_schedule": (lambda m: m.chain(
        m.add_weight_decay(0.01), m.scale(0.5),
        m.scale_by_schedule(m.inverse_sqrt(LR, 3))), 2e-6),
    "identity": (lambda m: m.identity(), 0.0),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transformation_matches_reference(case, name):
    """Every transformation, STEPS steps: updates, the state after each, and
    ``apply_updates`` on the parameters."""
    params_ref, grads = case
    make, rtol = TRANSFORMS[name]
    jt, tt = make(jopt), make(topt)
    pj = jax.tree_util.tree_map(jnp.asarray, params_ref)
    pt = _port_tree(params_ref)
    sj, st = jt.init(pj), tt.init(pt)
    _same(st, sj, 0.0, 0.0, where="init")
    for step, g in enumerate(grads):
        gj = jax.tree_util.tree_map(jnp.asarray, g)
        gt = _port_tree(g)
        uj, sj = jt.update(gj, sj, pj)
        ut, st = tt.update(gt, st, pt)
        if step == 0 and "adam" in name:
            _same_first_adam_step(ut, uj, g, rtol, where=name)
        else:
            _same(ut, uj, rtol, atol=rtol * LR,
                  where=f"{name} step {step} updates")
        _same(st, sj, rtol, where=f"{name} step {step} state")
        pj = jopt.base.apply_updates(pj, uj)
        topt.apply_updates(pt, ut)
        # a parameter moves by ~LR a step: its difference is the update's
        _same(pt, pj, rtol, atol=rtol * LR, where=f"{name} step {step} params")


NEAR_ZERO = {}  # name -> entries left out of Adam's first-step comparison


def _same_first_adam_step(port, ref, grads, rtol, where):
    """Adam's step 1 where ``|g| > 1e-6·max|g|``; the rest is counted in
    ``NEAR_ZERO`` (an update there may flip sign by 2·lr)."""
    tp, tr, tg = tflat(port), jflat(ref)[0], jflat(grads)[0]
    assert sorted(tp) == sorted(tr)
    g_max = max(float(np.abs(x).max()) for x in tg.values())
    left_out = 0
    for k in tr:
        keep = np.abs(tg[k]) > 1e-6 * g_max
        left_out += int((~keep).sum())
        np.testing.assert_allclose(tp[k][keep], np.asarray(tr[k])[keep],
                                   rtol=rtol, atol=rtol * LR,
                                   err_msg=f"{where} {k}")
    NEAR_ZERO[where] = left_out
    assert left_out < 10, f"{where}: {left_out} near-zero gradient entries"


def test_adafactor_factors_stacked_leaves(case):
    """A per-layer leaf is factored as the reference's stacked (L, ...)
    leaf: the 2-D stacked norm scale (L, D) has a row state (L,) and a
    column state (D,), the mean over the layer axis, and the RMS clip spans
    the L layers — a per-layer port of the same formula differs."""
    params_ref, grads = case
    pt = _port_tree(params_ref)
    opt = topt.adafactor(LR)
    st = opt.init(pt)
    ln = "layers/ln/scale"
    num_layers, d = len(pt[ln]), pt[ln][0].shape[0]
    assert st.row[ln].shape == (num_layers,) and st.col[ln].shape == (d,)
    assert st.full[ln].shape == ()
    assert st.row["ln_f/scale"].shape == () and st.full["ln_f/scale"].shape == (d,)
    ut, st = opt.update(_port_tree(grads[0]), st, pt)
    # one layer on its own is a 1-D leaf: unfactored, another update
    g0 = {"scale": (torch.from_numpy(grads[0]["layers"]["ln"]["scale"][0]),)}
    solo = topt.adafactor(LR)
    u0, _ = solo.update(g0, solo.init({"scale": (pt[ln][0],)}), None)
    assert not torch.allclose(u0["scale"][0], ut[ln][0])


ARCH = "jamba-1.5-large-398b"


def test_adafactor_on_the_hybrids_nested_leaves_matches_reference():
    """Two periods of the reduced jamba (the config's optimizer): its
    ``(P, n, ...)`` leaves are factored whole, as the reference's, over
    STEPS steps: updates, state and parameters."""
    cfg = dataclasses.replace(jreduced(jget_arch(ARCH)), num_layers=16)
    assert cfg.optimizer == "adafactor"
    params = jax.tree_util.tree_map(
        np.asarray, jbuild(cfg, dtype=jnp.float32).init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(6)
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.1).astype(np.float32), params)
        for _ in range(STEPS)]
    jt, tt = jopt.adafactor(LR), topt.adafactor(LR)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    pt = _port_tree(params, ARCH, num_layers=16)
    leaf = "periods/mamba/mixer/in_proj"
    assert isinstance(pt[leaf][0], tuple) and leaf_shape(pt[leaf])[:2] == (2, 7)
    sj, st = jt.init(pj), tt.init(pt)
    j_update = jax.jit(jt.update)
    assert st.row[leaf].shape == leaf_shape(pt[leaf])[:-1]
    _same(st, sj, 0.0, 0.0, where="init")
    for step, g in enumerate(grads):
        uj, sj = j_update(jax.tree_util.tree_map(jnp.asarray, g), sj, pj)
        ut, st = tt.update(_port_tree(g, ARCH, num_layers=16), st, pt)
        _same(ut, uj, 1e-5, atol=1e-5 * LR, where=f"step {step} updates")
        _same(st, sj, 1e-5, where=f"step {step} state")
        pj = jopt.base.apply_updates(pj, uj)
        topt.apply_updates(pt, ut)
        _same(pt, pj, 1e-5, atol=1e-5 * LR, where=f"step {step} params")


def test_global_norm_and_clip_match_reference(case):
    params_ref, grads = case
    gj = jax.tree_util.tree_map(jnp.asarray, grads[0])
    gt = _port_tree(grads[0])
    np.testing.assert_allclose(float(topt.global_norm(gt)),
                               float(jopt.base.global_norm(gj)), rtol=1e-5)
    clip = topt.clip_by_global_norm(1e-3)
    ut, _ = clip.update(gt, clip.init(gt))
    np.testing.assert_allclose(float(topt.global_norm(ut)), 1e-3, rtol=1e-5)


SCHEDULES = {
    "constant_lr": lambda m: m.constant_lr(3e-4),
    "cosine_decay": lambda m: m.cosine_decay(1e-3, 50, alpha=0.1),
    "warmup_cosine": lambda m: m.warmup_cosine(1e-3, 10, 60, floor=1e-5),
    "inverse_sqrt": lambda m: m.inverse_sqrt(1e-3, 8),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_reference(name):
    """Each schedule at counts 0..80 (past every breakpoint): a 0-d float32
    on the count's device, within rtol 1e-6 of the reference's (``cos``,
``sqrt`` and the divisions round differently in XLA and torch)."""
    js, ts = SCHEDULES[name](jopt), SCHEDULES[name](topt)
    for count in range(81):
        ref = np.asarray(js(jnp.asarray(count, jnp.int32)))
        out = ts(torch.tensor(count, dtype=torch.int32))
        assert out.dtype == torch.float32 and out.shape == ()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=0,
                                   err_msg=f"{name} at {count}")
