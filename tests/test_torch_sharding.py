"""The port's parameter-sharding rules and sharded training
(`summarymixing_tpu_torch/parallel/mesh.py`, `parallel/sharded.py`,
`training/trainer.py`) against the JAX package.

In process: under each rule (tensor parallel, FSDP, composite) on 2x2,
1x2 and 4x1 meshes, every parameter's placement equals the JAX rule's
spec of the flax leaf it is read from, carried through the weight
bridge itself: each flax leaf is filled with its shard index along the
axis the JAX rule splits (0 where it replicates), `load_jax_params` moves
that into the port's layout, and the port's `Shard(axis)` must cut the
port tensor into blocks holding 1, 2, ... in order. The small models have
square kernels (ties in FSDP's largest-dimension choice), a Conv2d, the
Conformer's depthwise kernel and the LSTM's packed gates.

Over one group of four gloo processes (`tests/torch_model_parallel_worker.py`,
no JAX there): three AdamW steps of a small recognizer with its decoder
(dropout 0, no augmentation), under one process on a 1x1 mesh, TP on a
1x2 mesh (processes 0 and 1), FSDP 4x1 and composite 2x2, from the same
weights and global batch of 8. TP's losses equal the one process's bit
for bit; FSDP's and composite's within 2.5e-5 relative (the data-parallel
tolerance); the parameters and moments are DTensors with the rule's
placements (some over "data", some over "model"), each process keeps the
rule's share of their elements, the sharded parameters' whole storage is
freed between steps, and the checkpoints (one writer) restore into one
process: TP's bit-equal to the one process's parameters. `make_mesh` and
`make_seq_mesh` take a model axis there too.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch.distributed.tensor import Replicate, Shard

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.config import build_model as jax_build_model
from summarymixing_tpu.config import load_recipe as jax_load_recipe
from summarymixing_tpu.parallel import mesh as jmesh
from summarymixing_tpu_torch.config import build_model, load_recipe
from summarymixing_tpu_torch.models.asr import TransformerASR
from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer
from summarymixing_tpu_torch.models.transducer import LSTMCell
from summarymixing_tpu_torch.parallel import mesh as tmesh
from summarymixing_tpu_torch.training.checkpoint import CheckpointManager
from summarymixing_tpu_torch.utils.convert import leaf_layouts, load_jax_params
from summarymixing_tpu_torch.utils.init import init_parameters
from test_torch_decoder import RECIPE, TINY_DEC

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS, STEPS = 4, 3
DP_TOL = 2.5e-5          # relative, as the data-parallel check on the card
TP_MIN, FSDP_MIN = 32, 256
RULES = {"tp": (jmesh.tensor_parallel_param_sharding, tmesh.tensor_parallel_param_sharding,
                dict(min_dim=TP_MIN)),
         "fsdp": (jmesh.fsdp_param_sharding, tmesh.fsdp_param_sharding,
                  dict(min_size=FSDP_MIN)),
         "composite": (jmesh.composite_param_sharding, tmesh.composite_param_sharding,
                       dict(tp_min_dim=TP_MIN, fsdp_min_size=FSDP_MIN))}
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "4x1": (4, 1)}


def _models():
    """(name, flax params shapes, port module) for each small model."""
    out = []
    for name, over in (("branchformer", dict(TINY_DEC, **{"model.d_ffn": 32})),
                       ("conformer", dict(TINY_DEC, **{"model.encoder_module": "conformer",
                                                       "model.num_decoder_layers": 0,
                                                       "model.d_ffn": 32}))):
        jmodel, _, _ = jax_build_model(jax_load_recipe(RECIPE, overrides=over))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 16, 80), jnp.float32), jnp.asarray([16]),
                                jnp.ones((1, 3), jnp.int32))["params"]
        out.append((name, shapes, build_model(load_recipe(RECIPE, overrides=over),
                                              device="cpu")[0]))
    cell = fnn.OptimizedLSTMCell(32)
    carry = cell.initialize_carry(jax.random.PRNGKey(0), (2, 16))
    shapes = jax.eval_shape(cell.init, jax.random.PRNGKey(1), carry,
                            jnp.zeros((2, 16), jnp.float32))["params"]
    out.append(("lstm", shapes, LSTMCell(16, 32)))
    return out


MODELS = _models()


@pytest.mark.parametrize("rule", sorted(RULES))
@pytest.mark.parametrize("grid", sorted(MESHES))
@pytest.mark.parametrize("model", [m[0] for m in MODELS])
def test_every_placement_is_the_jax_rules_through_the_bridge(rule, grid, model):
    n_data, n_model = MESHES[grid]
    jrule, trule, kw = RULES[rule]
    _, shapes, port = next(m for m in MODELS if m[0] == model)
    jax_mesh = jmesh.make_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    specs = jax.tree.map(lambda s: s.spec, jrule(jax_mesh, **kw)(shapes))
    placements = trule({"data": n_data, "model": n_model}, **kw)(port)
    layouts = leaf_layouts(port)
    assert set(placements) == {n for n, _ in port.named_parameters()}
    sizes = {"data": n_data, "model": n_model}
    sharded = 0
    for axis_i, axis in enumerate(("data", "model")):
        def fill(shape, spec):
            a = np.zeros(shape.shape, np.float32)
            for j, name in enumerate(tuple(spec)):
                if name == axis:
                    n = shape.shape[j] // sizes[axis]
                    idx = (np.arange(shape.shape[j]) // n + 1).astype(np.float32)
                    a = a + idx.reshape([-1 if i == j else 1 for i in range(len(shape.shape))])
            return a
        tree = jax.tree.map(fill, shapes, specs)
        load_jax_params(port, tree)
        for name, p in port.named_parameters():
            place = placements[name][axis_i]
            got = p.detach()
            if isinstance(place, Replicate):
                assert float(got.abs().max()) == 0.0, (name, axis, "the JAX rule shards it")
                continue
            sharded += 1
            n = sizes[axis]
            layout = layouts[name]
            if layout.count > 1 and place.dim == 0:
                # packed gates split along the packed axis: each gate's block
                # holds the flax leaf's shards in order
                got = got.reshape((layout.count, -1) + tuple(got.shape[1:]))
                blocks = got.chunk(n, dim=1)
            else:
                blocks = got.chunk(n, dim=place.dim)
            for k, block in enumerate(blocks):
                assert torch.all(block == k + 1), (name, axis, place, k)
    axes = {"tp": ("model",), "fsdp": ("data",), "composite": ("data", "model")}[rule]
    assert (sharded > 0) == any(sizes[a] > 1 for a in axes)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


ASR = dict(tgt_vocab=24, input_size=80, d_model=32, nhead=2, num_encoder_layers=2,
           num_decoder_layers=1, d_ffn=32, encoder_module="branchformer",
           attention_type="SummaryMixing", mode="SummaryMixing", kernel_size=5,
           csgu_linear_units=64, local_proj_hid_dim=(32,), local_proj_out_dim=32,
           summary_hid_dim=(32,), summary_out_dim=32, dropout_rate=0.0)
RUNS = ["single", "tp", "fsdp", "composite", "single_acc", "tp_acc", "composite_acc"]
ACC_STEPS, ACC_CLIP = 6, 1e-3   # 3 inner steps of 2 micro-batches, each clipped


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every run's results from the four processes."""
    tmp = tmp_path_factory.mktemp("shard")
    model = SpeechRecognizer(TransformerASR(**ASR), 24, frontend_channels=(4, 4))
    g = torch.Generator()
    g.manual_seed(0)
    init_parameters(model, g)
    torch.save(model.state_dict(), tmp / "state.pt")
    rng = np.random.default_rng(5)
    lens = np.array([8000, 7000, 6000, 8000, 5000, 8000, 7500, 6500])
    batch = {"wav": torch.from_numpy((rng.standard_normal((8, 8000)) * 0.1).astype(np.float32)),
             "wav_lens": torch.from_numpy(lens),
             "tokens": torch.from_numpy(rng.integers(3, 24, (8, 5))),
             "token_lens": torch.tensor([5, 4, 3, 5, 2, 5, 4, 3])}
    torch.save(batch, tmp / "batch.pt")
    cfg = {"state": str(tmp / "state.pt"), "batch": str(tmp / "batch.pt"), "asr": ASR,
           "vocab": 24, "frontend_channels": [4, 4], "n_mels": 80, "steps": STEPS,
           "runs": RUNS, "checkpoint": ["tp", "composite"], "tp_min_dim": TP_MIN,
           "acc_steps": ACC_STEPS, "acc_clip": ACC_CLIP,
           "fsdp_min_size": FSDP_MIN}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_model_parallel_worker.py"), "shard",
         str(tmp / "cfg.json"), str(tmp)],
        env=dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                 SMT_NUM_PROCESSES=str(RANKS), SMT_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    got = {run: {r: torch.load(tmp / f"{run}.rank{r}.pt", weights_only=False)
                 for r in range(RANKS) if (tmp / f"{run}.rank{r}.pt").exists()} for run in RUNS}
    meshes = [torch.load(tmp / f"meshes.rank{r}.pt", weights_only=False) for r in range(RANKS)]
    return tmp, got, meshes, model


def test_tensor_parallel_losses_equal_one_process_bit_for_bit(group):
    _, got, _, _ = group
    single = got["single"][0]["losses"]
    assert sorted(got["tp"]) == [0, 1]
    for r in (0, 1):
        assert got["tp"][r]["losses"] == single


@pytest.mark.parametrize("run", ["fsdp", "composite"])
def test_fsdp_and_composite_losses_within_the_data_parallel_tolerance(group, run):
    _, got, _, _ = group
    single = np.asarray(got["single"][0]["losses"])
    assert sorted(got[run]) == list(range(RANKS))
    for r in range(RANKS):
        losses = np.asarray(got[run][r]["losses"])
        assert np.all(np.isfinite(losses))
        np.testing.assert_allclose(losses, single, rtol=DP_TOL, atol=0)
        assert got[run][r]["losses"] == got[run][0]["losses"]


def _expected_share(model, run):
    sizes = {"tp": {"data": 1, "model": 2}, "fsdp": {"data": 4, "model": 1},
             "composite": {"data": 2, "model": 2}}[run]
    _, trule, kw = RULES[run]
    placements = trule(sizes, **kw)(model)
    kept = total = 0
    for name, p in model.named_parameters():
        div = 1
        for axis, place in zip(("data", "model"), placements[name]):
            if isinstance(place, Shard):
                div *= sizes[axis]
        kept += p.numel() // div
        total += p.numel()
    return kept / total, placements


@pytest.mark.parametrize("run", ["tp", "fsdp", "composite"])
def test_parameters_and_moments_are_placed_by_the_rule(group, run):
    """As the JAX trainer's state (`test_train_e2e.py` 196-320): the
    parameters and the AdamW moments carry the rule's placements, some
    over the data axis (FSDP) and some over the model axis (TP); each
    process keeps the rule's share of their elements, and between steps
    holds no whole copy of a sharded parameter."""
    _, got, _, model = group
    share, placements = _expected_share(model, run)
    want = {n: [repr(p) for p in pl] for n, pl in placements.items()}
    for out in got[run].values():
        assert out["params"] == want and out["moments"] == want
        assert out["param_share"] == pytest.approx(share, abs=1e-12)
        assert out["moment_share"] == pytest.approx(share, abs=1e-12)
        assert share < 1.0
        replicated = sum(p.numel() * 4 for n, p in model.named_parameters()
                         if all("Replicate" in s for s in want[n]))
        assert out["whole_between_steps"] == replicated
    flat = [s for pl in want.values() for s in pl]
    if run in ("fsdp", "composite"):
        assert any("Shard" in pl[0] for pl in want.values())
    if run in ("tp", "composite"):
        assert any("Shard" in pl[1] for pl in want.values())
    assert any("Shard" in s for s in flat)


@pytest.mark.parametrize("run", ["tp", "composite"])
def test_sharded_checkpoint_restores_into_one_process(group, run):
    """Process 0 writes the whole parameters and moments, as one process
    saves them; a one-process model loads them, and they equal the whole
    parameters every process of the run gathers. TP's equal the one
    process's after the same steps bit for bit; composite's lie within
    twice the sum of the three steps' learning rates of them (Adam moves a
    parameter by about its step's rate, and a near-zero gradient averaged
    over the data axis in another order may flip its direction)."""
    tmp, got, _, _ = group
    restored = CheckpointManager(str(tmp / f"ckpt_{run}")).restore(["params", "opt_state"],
                                                                 device="cpu")
    fresh = SpeechRecognizer(TransformerASR(**ASR), 24, frontend_channels=(4, 4))
    fresh.load_state_dict(restored["params"])
    assert [tuple(m.shape) for m in restored["opt_state"]["mu"]] == [
        tuple(p.shape) for p in fresh.parameters()]
    for r in got[run]:
        held = torch.load(tmp / f"{run}.params.rank{r}.pt", weights_only=True)
        for k, v in restored["params"].items():
            assert torch.equal(v, held[k]), (r, k)
    want = torch.load(tmp / "single.params.rank0.pt", weights_only=True)
    lr_sum = 1e-4 + 1e-4 + 2e-4   # noam(1e-3, 10) read at counts 0, 1, 2 (clamped at 1)
    for k, v in restored["params"].items():
        if run == "tp":
            assert torch.equal(v, want[k]), k
        else:
            torch.testing.assert_close(v, want[k], rtol=0, atol=2 * lr_sum)


def test_meshes_take_a_model_axis(group):
    _, _, meshes, _ = group
    assert [m["mesh"] for m in meshes] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [m["seq_mesh"] for m in meshes] == [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)]
    assert [m["rows"] for m in meshes] == [[0, 1], [0, 1], [2, 3], [2, 3]]


@pytest.mark.parametrize("run", ["tp_acc", "composite_acc"])
def test_accumulating_sharded_training_equals_one_process(group, run):
    """`MultiSteps(AdamW, 2)` under a rule, as the JAX trainer runs
    optax's `MultiSteps` under one: the accumulator is placed by the rule
    like the moments, and every inner step clips by the norm of the whole
    accumulator (the clip is active on all three), so TP's losses and
    parameters equal one process's bit for bit, and composite's lie within
    the data-parallel tolerance and twice the learning rates' sum."""
    tmp, got, _, model = group
    single = got["single_acc"][0]["losses"]
    assert len(single) == ACC_STEPS
    want = torch.load(tmp / "single_acc.params.rank0.pt", weights_only=True)
    _, placements = _expected_share(model, run.removesuffix("_acc"))
    placed = {n: [repr(p) for p in pl] for n, pl in placements.items()}
    lr_sum = 1e-4 + 1e-4 + 2e-4
    for r, out in got[run].items():
        assert out["acc"] == placed and out["moments"] == placed
        held = torch.load(tmp / f"{run}.params.rank{r}.pt", weights_only=True)
        if run == "tp_acc":
            assert out["losses"] == single
            for k, v in want.items():
                assert torch.equal(held[k], v), k
        else:
            np.testing.assert_allclose(out["losses"], single, rtol=DP_TOL, atol=0)
            for k, v in want.items():
                torch.testing.assert_close(held[k], v, rtol=0, atol=2 * lr_sum)
