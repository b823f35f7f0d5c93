"""Port parity: training checkpoints (``repro_torch.utils.checkpoint``) and
the resume of ``launch.train.run_training``.

The port writes the reference's layout (``step_%010d/`` with
``params.npz``, ``opt_state.npz``, ``walk_state.npz`` and a
``MANIFEST.json`` written last, stacked ``(L, ...)`` leaves under the
reference's key paths), so either package's checkpoint loads in the other
(the walk's generator state aside: the port stores ``get_state()`` bytes
where the reference stores a PRNG key).  A resumed port run equals the
uninterrupted one bit for bit on the CPU; a reference checkpoint resumes in
the port on blocks drawn from its saved key, with the update nodes equal
(``uniform``, static L) and the losses at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_arch as jget_arch, reduced as jreduced
from repro.launch import train as jtrain
from repro.models.factory import build_model as jbuild
from repro.utils import checkpoint as jckpt
from repro.walk_sgd import llm_trainer as jllm
from repro_torch import optim as topt
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import train as ttrain
from repro_torch.models.base import param_tree
from repro_torch.models.factory import build_model
from repro_torch.utils import checkpoint as tckpt
from repro_torch.walk_sgd import llm_trainer as tllm
from test_torch_llm_train import ref_block


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _state(arch="qwen2.5-32b", n=8):
    cfg = reduced(get_arch(arch))
    model = build_model(cfg, torch.float32, device="cpu",
                        generator=torch.Generator().manual_seed(1))
    params = param_tree(model)
    opt = topt.chain(topt.clip_by_global_norm(1.0), topt.adamw(1e-3))
    opt_state = opt.init(params)
    grads = topt.base.tree_map(torch.randn_like, params)
    updates, opt_state = opt.update(grads, opt_state, params)
    topt.apply_updates(params, updates)
    walk = tllm.init_walk_state(n, np.arange(1, n + 1), v0=3, seed=5,
                                online=True, device="cpu")
    walk["rng"].manual_seed(11)
    torch.rand(7, generator=walk["rng"])  # a generator mid-stream
    walk["p_j"] = torch.tensor(0.1)
    return cfg, params, opt_state, walk


def _equal(a, b):
    fa, fb = tckpt.flatten_with_paths(a), tckpt.flatten_with_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_port_checkpoint_round_trip(tmp_path):
    """Params, optimizer state and walk state (its generator mid-stream)
    come back bit for bit, into the structures, devices and dtypes of the
    ``like`` trees; the restored generator continues the same stream."""
    root = str(tmp_path / "ck")
    cfg, params, opt_state, walk = _state()
    tckpt.save_checkpoint(root, 7, params, opt_state, walk, extra={"a": 1})
    assert tckpt.latest_step(root) == 7
    _, like_p, like_o, like_w = _state()
    out = tckpt.load_checkpoint(root, like_p, like_o, like_w)
    assert out["step"] == 7 and out["extra"] == {"a": 1}
    _equal(out["params"], params)
    _equal(out["opt_state"], opt_state)
    _equal({k: v for k, v in out["walk_state"].items() if k != "rng"},
           {k: v for k, v in walk.items() if k != "rng"})
    assert isinstance(out["params"]["layers/attn/wq"], tuple)
    assert torch.equal(torch.rand(5, generator=out["walk_state"]["rng"]),
                       torch.rand(5, generator=walk["rng"]))
    # bfloat16 leaves are stored as the reference stores them
    bf = {"w": torch.randn(3, 4).to(torch.bfloat16)}
    tckpt.save_pytree(str(tmp_path / "bf.npz"), bf)
    with np.load(tmp_path / "bf.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    back = tckpt.load_pytree(str(tmp_path / "bf.npz"), bf)
    assert torch.equal(back["w"], bf["w"])
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"), like_p)
    with pytest.raises(ValueError):
        tckpt.load_pytree(str(tmp_path / "bf.npz"), {"w": torch.zeros(4, 3)})


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "jamba-1.5-large-398b"])
def test_port_checkpoint_round_trip_of_the_new_trees(tmp_path, arch):
    """A list entry (``dense_layers/0/...``) and the hybrid's stacks in
    stacks come back bit for bit in their tuple structure, the optimizer
    state too; a checkpoint of another structure is refused."""
    root = str(tmp_path / "ck")
    cfg, params, opt_state, walk = _state(arch)
    tckpt.save_checkpoint(root, 2, params, opt_state, walk)
    _, like_p, like_o, like_w = _state(arch)
    out = tckpt.load_checkpoint(root, like_p, like_o, like_w)
    _equal(out["params"], params)
    _equal(out["opt_state"], opt_state)
    if cfg.family == "hybrid":
        leaf = out["params"]["periods/mamba/mixer/in_proj"]
        assert isinstance(leaf[0], tuple) and len(leaf[0]) == 7
    else:
        assert isinstance(out["params"]["dense_layers/0/mlp/w_up"], torch.Tensor)
    _, other, _, _ = _state("olmoe-1b-7b")
    with pytest.raises((KeyError, ValueError)):  # a missing key, a stack's length
        tckpt.load_checkpoint(root, other)


def test_checkpoint_retention_and_incomplete_steps(tmp_path):
    root = str(tmp_path / "ck")
    tree = {"x": torch.arange(3.0)}
    for step in range(1, 6):
        tckpt.save_checkpoint(root, step, tree, keep=2)
    assert sorted(p.name for p in tmp_path.joinpath("ck").iterdir()) == [
        "step_0000000004", "step_0000000005"]
    assert tckpt.latest_step(root) == 5
    # a step directory without its manifest is not a checkpoint
    (tmp_path / "ck" / "step_0000000009").mkdir()
    assert tckpt.latest_step(root) == 5


@pytest.mark.parametrize("arch,opt", [
    ("mamba2-370m", "adamw"), ("deepseek-moe-16b", "adamw"),
    ("jamba-1.5-large-398b", "adafactor"), ("whisper-tiny", "adamw")])
def test_layout_is_the_references(tmp_path, arch, opt):
    """The same model, optimizer state (jamba's config names adafactor) and
    walk state written by each package: the same files, keys, shapes and
    dtypes (the MoE's ``dense_layers/0/...`` list entries, the hybrid's
    ``(P, n, ...)`` leaves, the encoder-decoder's trees); each package loads
    the other's params and optimizer state."""
    jcfg = jreduced(jget_arch(arch))
    jparams = jbuild(jcfg, dtype=jnp.float32).init(jax.random.PRNGKey(0))
    jopt_state = getattr(jopt, opt)(1e-3).init(jparams)
    jwalk = jllm.init_walk_state(8, None, online=True)
    jwalk["p_j"] = jnp.float32(0.0)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jparams, jopt_state, jwalk)

    from repro_torch import interop
    tm = interop.model_from_reference_params(
        reduced(get_arch(arch)),
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    params = param_tree(tm)
    opt_state = getattr(topt, opt)(1e-3).init(params)
    walk = tllm.init_walk_state(8, None, online=True, device="cpu")
    walk["p_j"] = torch.tensor(0.0)
    tckpt.save_checkpoint(str(tmp_path / "port"), 3, params, opt_state, walk)
    for name in ("params", "opt_state", "walk_state"):
        with np.load(tmp_path / "ref" / "step_0000000003" / f"{name}.npz") as a, \
                np.load(tmp_path / "port" / "step_0000000003" / f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                if k == "rng":  # a PRNG key against generator bytes
                    continue
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
                if name == "params":
                    np.testing.assert_array_equal(a[k], b[k])
    # each loads the other's
    out = tckpt.load_checkpoint(str(tmp_path / "ref"), params, opt_state, walk)
    np.testing.assert_array_equal(out["walk_state"]["rng"],
                                  np.asarray(jwalk["rng"]))  # kept as data
    _equal(out["params"], params)
    back = jckpt.load_checkpoint(str(tmp_path / "port"), jparams, jopt_state)
    for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class _Killed(Exception):
    pass


def _killer(at_step):
    seen = {"steps": 0}

    def on_phase(name):
        if name == "step":
            if seen["steps"] == at_step:
                raise _Killed
            seen["steps"] += 1

    return on_phase


def test_resume_is_bitwise(tmp_path):
    """A 12-step run killed at the top of step 6 (after its step-6
    checkpoint) and resumed equals the uninterrupted run bit for bit:
    losses, nodes, parameters, optimizer state and walk state (its
    generator included)."""
    cfg = reduced(get_arch("mamba2-370m"))
    kw = dict(graph_kind="ring", n_silos=8, method="mhlj", steps=12,
              batch_size=2, seq_len=16, lr=1e-3, log_every=0, seed=9,
              device="cpu")
    full = ttrain.run_training(cfg, **kw)
    root = str(tmp_path / "ck")
    with pytest.raises(_Killed):
        ttrain.run_training(cfg, **kw, checkpoint_dir=root, checkpoint_every=3,
                            on_phase=_killer(6))
    assert tckpt.latest_step(root) == 6
    resumed = ttrain.run_training(cfg, **kw, checkpoint_dir=root,
                                  checkpoint_every=3, resume=True)
    np.testing.assert_array_equal(resumed["update_nodes"], full["update_nodes"][6:])
    np.testing.assert_array_equal(resumed["losses"], full["losses"][6:])
    _equal(resumed["params"], full["params"])
    _equal(resumed["opt_state"], full["opt_state"])
    _equal({k: v for k, v in resumed["walk_state"].items() if k != "rng"},
           {k: v for k, v in full["walk_state"].items() if k != "rng"})
    assert torch.equal(resumed["walk_state"]["rng"].get_state(),
                       full["walk_state"]["rng"].get_state())


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "deepseek-moe-16b",
                                  "jamba-1.5-large-398b"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, arch):
    """The reference trains 5 steps and checkpoints; the port resumes from
    that checkpoint (its PRNG key kept as data) on the blocks drawn from
    the saved key and runs steps 5..9 as the reference's uninterrupted
    10-step run does (the MoE and hybrid trees too)."""
    jcfg = jreduced(jget_arch(arch))
    kw = dict(graph_kind="ring", n_silos=8, method="uniform", batch_size=2,
              seq_len=16, lr=1e-3, log_every=0, seed=4)
    root = str(tmp_path / "ref")
    jtrain.run_training(jcfg, steps=5, checkpoint_dir=root, checkpoint_every=5,
                        **kw)
    full = jtrain.run_training(jcfg, steps=10, **kw)
    with np.load(tmp_path / "ref" / "step_0000000005" / "walk_state.npz") as z:
        key = jnp.asarray(z["rng"])
    blocks = np.zeros((10, 1, 6), np.float32)
    for t in range(5, 10):
        key, blocks[t] = ref_block(key, 0.0)
    res = ttrain.run_training(reduced(get_arch(arch)), steps=10,
                              checkpoint_dir=root, resume=True, device="cpu",
                              uniforms=blocks, **kw)
    np.testing.assert_array_equal(res["update_nodes"], full["update_nodes"][5:])
    np.testing.assert_allclose(res["losses"], full["losses"][5:], rtol=1e-4)
    assert isinstance(res["walk_state"]["rng"], np.ndarray)
