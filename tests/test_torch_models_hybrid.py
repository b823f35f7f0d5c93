"""Port parity: the hybrid Mamba+attention+MoE LM (jamba-1.5-large-398b)
against the JAX package on the same weights.

Weights are the reference's own init carried by
``interop.model_from_reference_params``; inputs are numpy draws from a
seed; float32 on the CPU, held at atol = rtol = 2e-4.  With
``use_kernels`` the reference runs its SSD kernel as its own tests run it
on the CPU (Pallas in interpret mode) and the port the kernel's plain
version.  The routing margin is asserted as in ``test_torch_models_moe``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import hybrid as jhybrid
from repro.models.factory import build_model as jbuild
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import hybrid as thybrid
from repro_torch.models.base import (leaf_shape, named_of, param_tree, stack_paths,
                                     tree_of)
from test_torch_models import _ref_paths
from test_torch_models_moe import MARGIN, _close, _np, run_model_parity

ARCH = "jamba-1.5-large-398b"


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_period_structure_matches_reference():
    base = tconfigs.get_arch(ARCH)
    variants = [base, tconfigs.reduced(base),
                dataclasses.replace(base, moe_every=1),
                dataclasses.replace(base, moe_every=4, attn_offset=0),
                dataclasses.replace(base, num_experts=0)]
    for cfg in variants:
        jcfg = jconfigs.ArchConfig(**dataclasses.asdict(cfg))
        assert thybrid.period_structure(cfg) == jhybrid._period_structure(jcfg)
    layout, counts = thybrid.period_structure(base)
    assert counts == {"mamba": 7, "moe": 4, "mlp": 4}
    assert [m for m, *_ in layout].index("attn") == 4


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hybrid_apply_loss_decode_match_reference(use_kernels, monkeypatch):
    jcfg = jconfigs.reduced(jconfigs.get_arch(ARCH))
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 64))
    labels = rng.integers(0, jcfg.vocab_size, (2, 64))
    margin = run_model_parity(ARCH, use_kernels, tokens, labels, monkeypatch)
    assert margin > MARGIN, margin


def test_two_periods_nest_stacks_and_carry_both_ways():
    """Two periods of the reduced jamba: the reference's leaf paths, order
    and ``(P, n, ...)`` shapes (``periods/mamba/mixer/in_proj`` is (2, 7,
    ...), ``periods/attn/...`` (2, ...)); ``tree_of``/``named_of`` invert
    each other; reference -> port -> reference bit for bit; ``apply``
    equal."""
    jcfg = dataclasses.replace(jconfigs.reduced(jconfigs.get_arch(ARCH)),
                               num_layers=16)
    tcfg = dataclasses.replace(tconfigs.reduced(tconfigs.get_arch(ARCH)),
                               num_layers=16)
    jm = jbuild(jcfg, dtype=jnp.float32)
    params = _np(jm.init(jax.random.PRNGKey(7)))
    tm = interop.model_from_reference_params(tcfg, params, device="cpu")
    tree = param_tree(tm)
    ref = _ref_paths(params)
    assert list(tree) == list(ref)
    assert {k: leaf_shape(v) for k, v in tree.items()} == {k: s for k, (s, _) in
                                                             ref.items()}
    assert leaf_shape(tree["periods/mamba/mixer/in_proj"])[:2] == (2, 7)
    assert leaf_shape(tree["periods/moe/moe/w_gate"])[:2] == (2, 4)
    assert leaf_shape(tree["periods/attn/attn/wq"])[0] == 2
    assert isinstance(tree["periods/mamba/ln/scale"][1], tuple)
    named = dict(tm.named_parameters())
    stacks = stack_paths(tm)
    assert stacks == {"periods", "periods/mamba", "periods/moe", "periods/mlp"}
    back_named = named_of(tree_of(named, stacks), stacks)
    assert set(back_named) == set(named)
    assert all(back_named[k] is named[k] for k in named)
    back = interop.reference_params_of(tm)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 40))
    _close(tm.apply({"tokens": torch.from_numpy(tokens)}),
           jax.jit(jm.apply)(params, {"tokens": jnp.asarray(tokens, jnp.int32)}))
