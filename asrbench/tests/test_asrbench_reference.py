"""The plain float32 reference against the system under test at a tiny size
on the CPU, the system computing in float32 too: the greedy-decode forward
(CTC log-probabilities) and one training step (loss and every gradient as
the optimizer takes it, and the update past the schedule's warm-up), with the
same weights, inputs and draws; and the decode numbers on a fault confined
to one row."""

import pytest
import torch

from asrbench import harness
from asrbench.reference import asr as ref
from asrbench.reference import compare
from asrbench.tests.tiny import tiny_config, tiny_spec
from asrbench.yardstick import traffic
from asrbench.yardstick.weights import make_norm_stats, make_weights

TRAIN = harness.load_module("entries", "train")


def fp32(cfg):
    cfg["training"]["precision"] = "fp32"
    cfg["overrides"]["training.precision"] = "fp32"
    return cfg


@pytest.mark.parametrize("config", ["branchformer_summarymixing", "branchformer_mha"])
def test_decode_forward_matches_system(config):
    from summarymixing_tpu_torch.transcribe import greedy_ctc_decode

    cfg = fp32(tiny_config(config))
    spec = tiny_spec("bf_sm.decode", config=cfg)
    system = harness.build_system(cfg, "cpu")
    model, fbank = system.model, system.fbank
    w = make_weights(ref.param_shapes(cfg), 11, "cpu")
    harness.load_weights(system, w)
    stats = make_norm_stats(cfg["features"]["n_mels"], 12, "cpu")
    for b in traffic.make_pool(spec["mix"], 13, "cpu"):
        hyps, out = greedy_ctc_decode(model.eval(), fbank, stats, b.wav, b.wav_lens)
        lp, lens = ref.ctc_log_probs(w, cfg, stats, b.wav, b.wav_lens)
        assert torch.equal(lens, out["enc_lengths"])
        valid = torch.arange(lp.shape[1])[None] < lens[:, None]
        err = (lp - out["ctc_log_probs"]).abs()[valid].max()
        assert err < 2e-4, err
        assert ref.collapse(out["ctc_log_probs"].argmax(-1), lens) == hyps


def test_training_step_matches_system():
    cfg = fp32(tiny_config("branchformer_summarymixing"))
    spec = tiny_spec("bf_sm.train", config=cfg)
    system = harness.build_system(cfg, "cpu")
    model = system.model
    shapes = ref.param_shapes(cfg)
    w = make_weights(shapes, 21, "cpu")
    harness.load_weights(system, w)
    pool = traffic.make_pool(spec["mix"], 22, "cpu", vocab=cfg["model"]["output_neurons"])
    trainer = TRAIN.trainer(system.recipe, model, system.fbank)
    state = trainer.init_state(seed=23)
    state, met = trainer.train_step(state, TRAIN.feed(pool[0]))
    g = torch.Generator()
    g.manual_seed(23)
    tr = ref.Trainer(w, cfg)
    loss, grads = tr.step([TRAIN.feed(pool[0])], [g])
    assert abs(float(met["loss"]) - loss) <= 1e-5 * abs(loss)
    b1 = cfg["training"]["adam_betas"][0]
    names = [n for n, p in model.named_parameters()]
    for n, mu in zip(names, state["opt_state"]["mu"]):
        gs, gr = mu / (1.0 - b1), grads[n]
        assert (gs - gr).norm() <= 1e-4 * gr.norm() + 1e-7, n


def test_update_past_warmup_matches_system():
    """At the cell's `start_step` (the schedule's peak) both sides take the
    same real step: the change of every leaf the rule keeps agrees by norm."""
    cfg = fp32(tiny_config("branchformer_summarymixing"))
    spec = tiny_spec("bf_sm.train", config=cfg)
    assert spec["start_step"] == cfg["training"]["n_warmup_steps"]
    system = harness.build_system(cfg, "cpu")
    model = system.model
    shapes = ref.param_shapes(cfg)
    w = make_weights(shapes, 31, "cpu")
    harness.load_weights(system, w)
    pool = traffic.make_pool(spec["mix"], 32, "cpu", vocab=cfg["model"]["output_neurons"])
    trainer = TRAIN.trainer(system.recipe, model, system.fbank)
    state = trainer.init_state(seed=33)
    count = state["opt_state"]["count"]
    state = dict(state, step=spec["start_step"],
                 opt_state=dict(state["opt_state"], count=torch.full_like(count, spec["start_step"])))
    theta0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer.train_step(state, TRAIN.feed(pool[0]))
    g = torch.Generator()
    g.manual_seed(33)
    tr = ref.Trainer(w, cfg, count=spec["start_step"])
    _, grads = tr.step([TRAIN.feed(pool[0])], [g])
    names = [n for n, _ in shapes]
    named = dict(model.named_parameters())
    prog = {"losses": [1.0], "grad_norms": compare.leaf_norms([grads[n] for n in names]),
            "update_norms": compare.leaf_norms([named[n] - theta0[n] for n in names])}
    out = {"losses": [1.0], "grad_norms": prog["grad_norms"],
           "update_norms": compare.leaf_norms([tr.w[n] - w[n] for n in names])}
    step = max(out["update_norms"])
    # a real step: the schedule's peak rate moves the largest leaf by far
    # more than the warm-up's first steps (about 1e-8 per element) would
    assert step > 1e-3, step
    assert compare.train_numbers(prog, out)["update_gap"] < 1e-3


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_kl_row_max_sees_one_row(shift):
    """A fault confined to one row of 64: `kl_mean` takes a 64th of it,
    `kl_row_max` all of it."""
    gen = torch.Generator().manual_seed(3)
    ref_lp = torch.log_softmax(torch.randn(64, 40, 30, generator=gen), dim=-1)
    sys_lp = ref_lp.clone()
    sys_lp[7] = torch.log_softmax(ref_lp[7] + shift * torch.randn(40, 30, generator=gen), dim=-1)
    lens = torch.full((64,), 40)
    hyps = ref.collapse(sys_lp.argmax(-1), lens)
    n = compare.decode_numbers([{"hyps": hyps, "lp": sys_lp, "lens": lens, "ref_lp": ref_lp,
                                 "ref_lens": lens}])
    row = float((torch.exp(ref_lp[7]) * (ref_lp[7] - sys_lp[7])).sum(-1).mean())
    assert n["hyp_rows_wrong"] == 0
    assert n["kl_row_max"] == pytest.approx(row, rel=1e-5, abs=1e-9)
    assert n["kl_mean"] == pytest.approx(row / 64, rel=1e-5, abs=1e-9)
