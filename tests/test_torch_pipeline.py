"""The port's GPipe schedule (`summarymixing_tpu_torch/parallel/pipeline.py`)
over one group of four gloo processes on the CPU, with the cases of
`tests/test_pipeline_parallel.py`: it matches the sequential stack for
several `n_micro` and batch sizes (2x2 and 1x4 data x pipe meshes), a
single stage (4x1) degenerates to microbatched execution, bad partitions
are refused with the JAX messages, training-mode dropout is deterministic
per seed and differs from eval and between seeds, and the gradients of a
loss through the pipelined stack match the sequential stack's. The pad
masks differ between microbatches (lengths t - (i mod t/2)), so a stage
that applied another microbatch's mask would show.

The weights are the JAX encoder's `scan_layers=True` tree (stacked
`layers: [L, ...]`), read into the port by `load_jax_params`, and the
port's output is held against the JAX `pipeline_branchformer_encode` on
the same stacked weights (8 virtual devices, a 2x4 mesh, 4 microbatches
of all 16 rows) within 1e-4
(float32, the sums in another order than XLA's), and against the
sequential encode of the same microbatches in the same worker process
bit for bit. Gradients: within rtol 5e-4, atol 1e-5 of the port's
sequential stack, as the JAX test holds its own. The processes
(`tests/torch_model_parallel_worker.py`) import no JAX.
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

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.models.branchformer import BranchformerEncoder as JBranchformerEncoder
from summarymixing_tpu.parallel.pipeline import make_pipeline_mesh as jmake_pipeline_mesh
from summarymixing_tpu.parallel.pipeline import pipeline_branchformer_encode as jpipeline
from summarymixing_tpu_torch.models.branchformer import BranchformerEncoder
from summarymixing_tpu_torch.parallel import pipeline
from summarymixing_tpu_torch.utils.convert import load_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS, T, D = 4, 24, 16
JAX_TOL = 1e-4
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
ENCODER = dict(num_layers=4, d_model=D, nhead=2, kernel_size=5, dropout_rate=0.0,
               attention_type="SummaryMixing", csgu_linear_units=32, local_proj_hid_dim=[16],
               local_proj_out_dim=16, summary_hid_dim=[16], summary_out_dim=16,
               mode="SummaryMixing")
CASES = [dict(name="m4_b8", n_data=2, n_pipe=2, n_micro=4, b=8, grad=True),
         dict(name="m8_b16", n_data=2, n_pipe=2, n_micro=8, b=16),
         dict(name="m4_b8_four_stages", n_data=1, n_pipe=4, n_micro=4, b=8, grad=True),
         dict(name="single_stage", n_data=4, n_pipe=1, n_micro=2, b=16),
         dict(name="dropout", n_data=2, n_pipe=2, n_micro=4, b=8, dropout=True, grad=True,
              seed=42, encoder=dict(ENCODER, dropout_rate=0.3)),
         dict(name="layers", n_data=1, n_pipe=4, n_micro=4, b=8, refuse=True,
              encoder=dict(ENCODER, num_layers=6), state=""),
         dict(name="n_micro", n_data=2, n_pipe=2, n_micro=3, b=8, refuse=True),
         dict(name="data_axis", n_data=4, n_pipe=1, n_micro=4, b=8, refuse=True)]


def _jax_encoder(**kw):
    kw = dict(ENCODER, **kw)
    kw["local_proj_hid_dim"] = tuple(kw["local_proj_hid_dim"])
    kw["summary_hid_dim"] = tuple(kw["summary_hid_dim"])
    return JBranchformerEncoder(scan_layers=True, **kw)


def _data(b=16):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((b, T, D)).astype(np.float32)
    lens = T - (np.arange(b) % (T // 2))
    return x, (np.arange(T)[None, :] < lens[:, None]).astype(np.float32)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipe")
    x, pad = _data()
    jenc = _jax_encoder()
    params = jenc.init(jax.random.PRNGKey(0), jnp.asarray(x[:8]), None, jnp.asarray(pad[:8]))
    assert params["params"]["layers"]["norm_conv"]["scale"].shape == (4, D)
    enc = load_jax_params(BranchformerEncoder(**ENCODER), params)
    torch.save(enc.state_dict(), tmp / "state.pt")
    torch.save(torch.from_numpy(x), tmp / "x.pt")
    torch.save(torch.from_numpy(pad), tmp / "pad.pt")
    cfg = {"encoder": ENCODER, "state": str(tmp / "state.pt"), "x": str(tmp / "x.pt"),
           "pad": str(tmp / "pad.pt"), "cases": CASES}
    (tmp / "cfg.json").write_text(json.dumps(cfg))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_model_parallel_worker.py"), "pipe",
         str(tmp / "cfg.json"), str(tmp)],
        env=dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                 SMT_NUM_PROCESSES=str(RANKS), SMT_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    got = {c["name"]: [torch.load(tmp / f"{c['name']}.rank{r}.pt", weights_only=True)
                       for r in range(RANKS)] for c in CASES if not c.get("refuse")}
    refusals = [json.loads((tmp / f"refusals.rank{r}.json").read_text()) for r in range(RANKS)]
    # the JAX pipeline once over all 16 rows: rows are independent, so each
    # case's rows are its first b
    jmesh = jmake_pipeline_mesh(n_data=2, n_pipe=4)
    want = np.asarray(jpipeline(jenc, jmesh, n_micro=4)(
        params["params"], jnp.asarray(x), None, jnp.asarray(pad)))
    return want, enc, x, pad, got, refusals


@pytest.mark.parametrize("case", ["m4_b8", "m8_b16", "m4_b8_four_stages", "single_stage"])
def test_pipeline_matches_sequential_and_the_jax_pipeline(piped, case):
    want, _, _, _, got, _ = piped
    b = next(c for c in CASES if c["name"] == case)["b"]
    for out in got[case]:
        assert out["out"].shape == (b, T, D)
        assert torch.equal(out["out"], out["seq"])
        np.testing.assert_allclose(out["out"].numpy(), want[:b], rtol=JAX_TOL, atol=JAX_TOL)


def test_pipeline_rejects_bad_partitions(piped):
    refusals = piped[-1]
    for r in refusals:
        assert r["layers"] == "6 layers not divisible by pipe axis 4"
        assert r["n_micro"] == "batch 8 not divisible by n_micro=3"
        assert r["data_axis"].startswith("microbatch size 2 not divisible by the data axis (4)")


def test_pipeline_training_mode_dropout(piped):
    """seed= turns on dropout, drawn per (data index, microbatch, layer):
    the same seed gives the same output, another seed another, and both
    differ from the eval path; the gradients are finite."""
    got = piped[-2]
    for out in got["dropout"]:
        assert torch.equal(out["train"], out["train2"])
        assert not torch.allclose(out["train"], out["out"])
        assert not torch.allclose(out["train"], out["train7"])
        assert all(torch.isfinite(g).all() for g in out["grads"].values())
        assert torch.isfinite(out["x_grad"]).all()


@pytest.mark.parametrize("case", ["m4_b8", "m4_b8_four_stages"])
def test_pipeline_gradients_match_the_sequential_stack(piped, case):
    """The gradient of sum(out²): each process holds its stage's layers
    only, summed over the data axis; the norm's and the input's
    gradients on every process."""
    _, enc, x, pad, got, _ = piped
    c = next(c for c in CASES if c["name"] == case)
    b, n_stages = c["b"], c["n_pipe"]
    ref = BranchformerEncoder(**ENCODER)
    ref.load_state_dict(enc.state_dict())
    ref.eval()
    xg = torch.from_numpy(x[:b]).requires_grad_()
    (ref(xg, None, torch.from_numpy(pad[:b])) ** 2).sum().backward()
    per = ENCODER["num_layers"] // n_stages
    for rank, out in enumerate(got[case]):
        stage = rank % n_stages
        for name, g in out["grads"].items():
            assert g.shape[0] == per
            for j in range(per):
                li = stage * per + j
                want = dict(getattr(ref, f"layer_{li}").named_parameters())[name].grad
                torch.testing.assert_close(g[j], want, **GRAD_TOL)
        for name, g in out["norm_grads"].items():
            torch.testing.assert_close(g, dict(ref.norm.named_parameters())[name].grad,
                                       **GRAD_TOL)
        torch.testing.assert_close(out["x_grad"], xg.grad, **GRAD_TOL)


def test_stacked_params_and_the_mesh_refusal():
    """`stacked_params` stacks every layer's parameters; a mesh that leaves
    a device out is refused."""
    enc = BranchformerEncoder(**ENCODER)
    stacked = pipeline.stacked_params(enc)
    assert stacked["layers"]["norm_conv.weight"].shape == (4, D)
    with pytest.raises(ValueError, match="does not use all"):
        pipeline.make_pipeline_mesh(n_data=3, n_pipe=2, devices=[0, 1, 2, 3])
