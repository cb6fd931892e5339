"""The port's time-sharded encode and greedy CTC decode
(`summarymixing_tpu_torch/parallel/sequence.py`) over two gloo processes
on the CPU, against the JAX package's single-device encode and greedy
decode on the same weights (carried by `utils.convert.load_jax_params`),
with ragged lengths: the cases of `tests/test_sequence_parallel.py`
(Branchformer full mode, Conformer fast mode). The weights, features and
results pass through files, so the JAX side runs in this process alone;
the two processes (`tests/torch_dist_worker.py`) import only the port.
T = 66 feature frames gives T' = 17 encoder frames: shards of 9 and 8.

Also the refusals (a mesh that leaves a process out, a time axis that
does not divide) and the plain versions of the kernels' routes on a
shard: the cell's split route (partial sums per shard, their sum, the
finish) and the cgMLP on a shard extended by its halo, each against its
whole-T plain version within 1e-5 in float32.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import worker_cpus  # noqa: F401  (pins each xdist worker to its own cores)
from summarymixing_tpu.decoding.ctc import ctc_greedy_decode
from summarymixing_tpu.models.asr import TransformerASR as JTransformerASR
from summarymixing_tpu.models.speech_recognizer import SpeechRecognizer as JSpeechRecognizer
from summarymixing_tpu_torch.models.asr import TransformerASR
from summarymixing_tpu_torch.models.speech_recognizer import SpeechRecognizer
from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
from summarymixing_tpu_torch.parallel import launch, sequence
from summarymixing_tpu_torch.parallel.mesh import make_mesh
from summarymixing_tpu_torch.utils.convert import load_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
VOCAB, T, RANKS = 40, 66, 2
ENC_TOL = 1e-4    # float32 through two layers, the sums in another order than XLA's
CASES = {"branchformer_full": ("branchformer", "SummaryMixing"),
         "conformer_fast": ("conformer", "SummaryMixing-fast")}


def _asr_kwargs(encoder_module, mode):
    return dict(tgt_vocab=VOCAB, input_size=80, d_model=16, nhead=2, num_encoder_layers=2,
                num_decoder_layers=0, d_ffn=32, encoder_module=encoder_module,
                attention_type="SummaryMixing", mode=mode, causal=False, kernel_size=5,
                csgu_linear_units=32, local_proj_hid_dim=(16,), local_proj_out_dim=16,
                summary_hid_dim=(16,), summary_out_dim=16, dropout_rate=0.0)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX references and the two processes' results for every case."""
    tmp = tmp_path_factory.mktemp("seq")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((4, T, 80)).astype(np.float32)
    lens = np.asarray([T, T - 9, T // 2, T - 1], np.int32)
    cases, refs = [], {}
    for name, (enc_mod, mode) in CASES.items():
        kw = _asr_kwargs(enc_mod, mode)
        jmodel = JSpeechRecognizer(asr=JTransformerASR(**kw), vocab_size=VOCAB,
                                   frontend_channels=(4, 4), frontend_dropout=0.0)
        params = jmodel.init(jax.random.PRNGKey(0), feats, lens)
        enc, enc_len = jmodel.apply(params, feats, lens, method=jmodel.encode)
        ids, keep = ctc_greedy_decode(jmodel.apply(params, enc, method=jmodel.ctc_head), enc_len)
        refs[name] = {"enc": np.asarray(enc), "enc_len": np.asarray(enc_len),
                      "ids": np.asarray(ids), "keep": np.asarray(keep)}
        port = SpeechRecognizer(TransformerASR(**kw), VOCAB, frontend_channels=(4, 4))
        load_jax_params(port, jax.tree.map(np.asarray, params))
        torch.save(port.state_dict(), tmp / f"{name}.state.pt")
        cases.append({"name": name, "asr": kw, "vocab": VOCAB, "frontend_channels": [4, 4],
                      "state": str(tmp / f"{name}.state.pt"), "feats": str(tmp / "feats.pt"),
                      "lens": str(tmp / "lens.pt")})
    torch.save(torch.from_numpy(feats), tmp / "feats.pt")
    torch.save(torch.from_numpy(lens).to(torch.int64), tmp / "lens.pt")
    (tmp / "cases.json").write_text(json.dumps(cases))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"), "seq",
         str(tmp / "cases.json"), str(tmp)],
        env=dict(os.environ, SMT_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                 SMT_NUM_PROCESSES=str(RANKS), SMT_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(RANKS)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-3000:] for o in outs)
    got = {name: [torch.load(tmp / f"{name}.rank{r}.pt", weights_only=True)
                  for r in range(RANKS)] for name in CASES}
    refusals = [(tmp / f"refusal.rank{r}.txt").read_text() for r in range(RANKS)]
    meshes = [torch.load(tmp / f"mesh.rank{r}.pt", weights_only=True) for r in range(RANKS)]
    return refs, got, refusals, meshes


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_sharded_encode_matches_jax_single_device(sharded, case):
    refs, got, _, _ = sharded
    ref = refs[case]
    t_out = ref["enc"].shape[1]
    local = -(-t_out // RANKS)
    shards = [g["enc"].numpy() for g in got[case]]
    assert [s.shape[1] for s in shards] == [min(local, t_out - r * local) for r in range(RANKS)]
    enc = np.concatenate(shards, axis=1)
    valid = np.arange(t_out)[None, :] < ref["enc_len"][:, None]
    for g in got[case]:
        np.testing.assert_array_equal(g["enc_len"].numpy(), ref["enc_len"])
    np.testing.assert_allclose(np.where(valid[..., None], enc, 0.0),
                               np.where(valid[..., None], ref["enc"], 0.0),
                               rtol=ENC_TOL, atol=ENC_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_sharded_greedy_ctc_matches_jax_single_device(sharded, case):
    refs, got, _, _ = sharded
    ref = refs[case]
    for g in got[case]:   # every process holds the whole [B, T'] ids and marks
        np.testing.assert_array_equal(g["dec_len"].numpy(), ref["enc_len"])
        np.testing.assert_array_equal(g["keep"].numpy(), ref["keep"])
        np.testing.assert_array_equal(np.where(ref["keep"], g["ids"].numpy(), 0),
                                      np.where(ref["keep"], ref["ids"], 0))


def test_time_axis_that_does_not_divide_is_refused_on_every_process(sharded):
    _, _, refusals, _ = sharded
    assert all("not divisible by the seq" in r for r in refusals), refusals


def test_data_mesh_splits_a_batch_by_process(sharded):
    """`make_mesh()` over the two processes: each holds its rows of a batch
    (`shard_batch`), split over the data axis (`Shard(0)`), the rest
    replicated."""
    meshes = sharded[3]
    assert [m["rows"].tolist() for m in meshes] == [[0, 1], [2, 3]]
    assert all(m["placements"] == ["Shard(dim=0)", "Replicate()"] for m in meshes)
    assert all(m["replicated"] == ["Replicate()", "Replicate()"] for m in meshes)


def test_meshes_that_leave_a_device_out_are_refused():
    with pytest.raises(ValueError, match="does not use all"):
        sequence.make_seq_mesh(n_data=3, n_seq=2)
    with pytest.raises(ValueError, match="does not use all"):
        make_mesh(n_data=2, devices=[0, 1, 2])
    with pytest.raises(ValueError, match="does not use all"):
        make_mesh(n_data=1, n_model=2, devices=[0, 1, 2])


def test_what_couples_every_pair_of_frames_is_refused():
    """Attention, a causal encoder and expdecay's `[T, T]` weights have no
    time-sharded form: the encode refuses the model, the cell refuses
    expdecay on a shard."""
    from summarymixing_tpu_torch.ops.summary_mixing import SummaryMixing

    for kw in (dict(attention_type="regularMHA"), dict(causal=True)):
        model = SpeechRecognizer(TransformerASR(**dict(_asr_kwargs("branchformer", "SummaryMixing"),
                                                       **kw)), VOCAB, frontend_channels=(4, 4))
        with pytest.raises(NotImplementedError, match="time-sharded encode"):
            sequence.check_shardable(model)
    cell = SummaryMixing(8, local_proj_hid_dim=(8,), local_proj_out_dim=8, summary_hid_dim=(8,),
                         summary_out_dim=8, mode="SummaryMixing-expdecay")
    with sequence.TimeShard(None, 0, 1, 5).active():
        with pytest.raises(NotImplementedError, match="not expdecay"):
            cell(torch.zeros(1, 5, 8))


def test_time_check_names_the_axis():
    with pytest.raises(ValueError, match="not divisible by the seq mesh axis"):
        sequence._check_time_divisible(torch.zeros(2, 65, 80), 2)
    sequence._check_time_divisible(torch.zeros(2, 66, 80), 2)


def test_one_process_helpers():
    assert launch.process_count() == 1 and launch.local_rows(6) == slice(0, 6)
    shard = sequence.TimeShard(None, 0, 1, 5)
    x = torch.arange(10.0).reshape(1, 5, 2)
    ext = shard.halo(x, 2, 1)   # one shard: zeros past both ends
    assert ext.shape == (1, 8, 2) and ext[:, :2].abs().sum() == 0 and ext[:, -1].abs().sum() == 0
    shard.set_pad(torch.ones(1, 5))
    assert shard.pad_window(2, 1).tolist() == [[0, 0, 1, 1, 1, 1, 1, 0]]


def _cell_weights(g, d=16, hidden=24, out=32, n=16):
    def w(*shape):
        return torch.randn(*shape, generator=g) * shape[-1] ** -0.5 if len(shape) > 1 \
            else torch.randn(*shape, generator=g) * 0.1
    merge = w(n, out + out)
    return (w(hidden, d), w(hidden), w(out, hidden), w(out), w(hidden, d), w(hidden),
            w(out, hidden), w(out), merge[:, :out], merge[:, out:], w(n))


def test_plain_split_cell_equals_the_whole_t_plain_version():
    """The split route's plain versions on three shards of T (the last one
    shorter), the partial sums and counts added as the all-reduce would
    add them, against `summary_mixing_reference` over the whole T."""
    g = torch.Generator().manual_seed(3)
    b, t = 3, 23
    x = torch.randn(b, t, 16, generator=g)
    lens = torch.tensor([23, 15, 4])
    pad = (torch.arange(t)[None, :] < lens[:, None]).to(torch.float32)[..., None]
    weights = _cell_weights(g)
    whole = fused_summary.summary_mixing_reference(x, pad, weights, "gelu")
    local = -(-t // 3)
    bounds = [(i, min(i + local, t)) for i in range(0, t, local)]
    parts = [fused_summary.fused_summary_partial(x[:, a:z], pad[:, a:z], weights, "gelu")
             for a, z in bounds]
    total = sum(p[0] for p in parts)
    count = sum(p[1] for p in parts)
    out = torch.cat([fused_summary.fused_summary_finish(p[2], pad[:, a:z], total, count, weights,
                                                        "gelu", torch.float32)
                     for p, (a, z) in zip(parts, bounds)], dim=1)
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("first,size", [(0, 12), (12, 12), (20, 9)])
def test_plain_halo_cgmlp_equals_the_whole_t_plain_version(first, size):
    """The cgMLP's plain version on a shard extended by (K-1)//2 halo
    frames each side (zeros past the ends, with their pad mask) gives the
    whole-T plain version's frames of the shard."""
    g = torch.Generator().manual_seed(4)
    b, t, d, units, k = 2, 29, 8, 16, 5
    x = torch.randn(b, t, d, generator=g)
    mask = (torch.arange(t)[None, :] < torch.tensor([29, 17])[:, None]).to(torch.float32)
    weights = (torch.randn(units, d, generator=g) * d ** -0.5, torch.randn(units, generator=g),
               1.0 + 0.1 * torch.randn(units // 2, generator=g),
               0.1 * torch.randn(units // 2, generator=g),
               torch.randn(k, units // 2, generator=g) * k ** -0.5,
               torch.randn(units // 2, generator=g),
               torch.randn(d, units // 2, generator=g) * (units // 2) ** -0.5,
               torch.randn(d, generator=g))
    whole = fused_csgu.convolution_branch_reference(x, mask, weights)
    h = (k - 1) // 2
    lo, hi = first - h, first + size + h
    xw = torch.zeros(b, size + 2 * h, d)
    mw = torch.zeros(b, size + 2 * h)
    a, z = max(lo, 0), min(hi, t)
    xw[:, a - lo:z - lo], mw[:, a - lo:z - lo] = x[:, a:z], mask[:, a:z]
    got = fused_csgu.fused_convolution_branch(xw, mw, weights)[:, h:h + size]
    torch.testing.assert_close(got[:, :max(0, min(size, t - first))],
                               whole[:, first:first + size], rtol=1e-5, atol=1e-5)
