"""The port's training slice against the JAX package on the CPU: losses,
one whole train step (losses, every gradient, the global norm and the
parameters after one AdamW + Noam + clip step), the non-finite skip, the
augmentations with the JAX draws fed in, the xavier overwrite, the kernel
wrappers' autograd Functions, and the kernels' plain versions with
dropout keep-masks. Tiny sizes (tests/test_torch_decoder.py's TINY_DEC);
weights from flax `init` through `load_jax_params`; inputs from a numpy
seed."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from summarymixing_tpu.frontend import augment as jaug
from summarymixing_tpu.frontend.features import Fbank as JFbank
from summarymixing_tpu.frontend.features import NormStats as JNormStats
from summarymixing_tpu.losses import ctc_loss as jctc_loss
from summarymixing_tpu.losses import kldiv_loss as jkldiv_loss
from summarymixing_tpu.ops.convolution import depthwise_conv1d as jdepthwise
from summarymixing_tpu.ops.summary_mixing import SummaryMixing as JSummaryMixing
from summarymixing_tpu.parallel.mesh import make_mesh
from summarymixing_tpu.training import optim as joptim
from summarymixing_tpu.training.trainer import ASRTrainer as JTrainer
from summarymixing_tpu.training.trainer import TrainerConfig as JTrainerConfig
from summarymixing_tpu.utils.init import _torch_xavier_std
from summarymixing_tpu_torch.frontend import augment as taug
from summarymixing_tpu_torch.frontend.features import Fbank
from summarymixing_tpu_torch.losses import ctc_loss, kldiv_loss
from summarymixing_tpu_torch.ops import convolution as tconv
from summarymixing_tpu_torch.ops import fused_csgu, fused_summary
from summarymixing_tpu_torch.ops import summary_mixing as tsm
from summarymixing_tpu_torch.ops.layers import Dropout, set_dropout_generator
from summarymixing_tpu_torch.training import optim as toptim
from summarymixing_tpu_torch.training.trainer import ASRTrainer, TrainerConfig
from summarymixing_tpu_torch.utils.convert import load_jax_params
from summarymixing_tpu_torch.utils.init import xavier_normal_overwrite, xavier_std
from test_torch_decoder import tiny_models

LR, WARMUP = 1e-2, 4        # lr(0) = 2.5e-3: an update well above float32 noise


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype))


def _batch(rng, n=3):
    secs = [0.5, 0.3, 0.42][:n]
    wav = np.zeros((n, 8000), np.float32)
    for i, s in enumerate(secs):
        wav[i, :int(16000 * s)] = 0.3 * rng.standard_normal(int(16000 * s))
    lens = np.array([int(16000 * s) for s in secs], np.int32)
    tokens = rng.integers(3, 16, (n, 5)).astype(np.int32)
    token_lens = np.array([5, 2, 4][:n], np.int32)
    return {"wav": wav, "wav_lens": lens, "tokens": tokens, "token_lens": token_lens}


def _port_trainer(tmodel, **cfg):
    opt = toptim.AdamW(toptim.noam_schedule(LR, WARMUP), weight_decay=0.01,
                       betas=(0.9, 0.98), eps=1e-9, max_grad_norm=5.0)
    config = TrainerConfig(**dict(dict(ctc_weight=0.3, label_smoothing=0.0, augment=None,
                                       xavier_init_overwrite=False), **cfg))
    return ASRTrainer(tmodel, opt, Fbank(win_length_ms=32.0), config)


def test_train_step_matches_jax_trainer(rng):
    """Dropout 0, no augmentation, fp32: the port's `train_step` against
    `ASRTrainer._forward_loss` under `jax.value_and_grad` and
    `apply_safe_update` with optax's AdamW + Noam + clip. Losses and the
    global norm within 1e-5 relative; every gradient within 2e-4 of the
    largest of its tensor (float32 sums in another order through two
    encoder and two decoder layers, the CTC recursions differ); the
    parameters after the step within 1e-6 absolute (lr is 2.5e-3), except
    where a gradient is below 2e-3 of its tensor's largest: there the
    gradient is known only to about its own size, and Adam's first step,
    lr · g / (|g| + eps), is then not known to 1e-6. Gradients that are 0
    in exact arithmetic (the attention's key bias: a shift of every score
    of a row) come out as float32 noise below 1e-8 in both and are held to
    that. At least 90% of the elements are compared."""
    jmodel, tmodel, params = tiny_models()
    batch = _batch(rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jtrainer = JTrainer(jmodel, joptim.make_adamw(joptim.noam_schedule(LR, WARMUP), 0.01),
                        JFbank(win_length_ms=32.0),
                        JTrainerConfig(ctc_weight=0.3, label_smoothing=0.0, augment=None,
                                       xavier_init_overwrite=False),
                        mesh=make_mesh(devices=jax.devices()[:1]))
    jparams = params["params"]
    stats0 = JNormStats.init(80)
    grad_fn = jax.jit(jax.value_and_grad(jtrainer._forward_loss, has_aux=True),
                      static_argnums=(4,))
    (_, (jlosses, jstats, _)), jgrads = grad_fn(jparams, stats0, jbatch, jax.random.PRNGKey(0),
                                                False, 0, 0)
    jstate = {"params": jparams, "opt_state": jtrainer.tx.init(jparams), "norm_stats": stats0,
              "step": jnp.zeros((), jnp.int32), "epoch": jnp.zeros((), jnp.int32),
              "rng": jax.random.PRNGKey(1)}
    jnew, jnorm, jfinite = jax.jit(functools.partial(joptim.apply_safe_update, jtrainer.tx))(
        jstate, jgrads, jlosses, jstats, jax.random.PRNGKey(1))
    assert bool(jfinite)

    trainer = _port_trainer(tmodel)
    state = trainer.init_state(seed=0)
    before = [p.detach().clone() for p in trainer.params]
    state, metrics = trainer.train_step(state, tbatch)
    for key in ("loss", "ctc", "att"):
        np.testing.assert_allclose(float(metrics[key]), float(jlosses[key]), rtol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-5)
    assert metrics["nonfinite_skipped"] == 0 and state["step"] == 1
    for key in ("count", "mean", "m2"):
        np.testing.assert_allclose(state["norm_stats"][key].numpy(), np.asarray(jstats[key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)

    gmod = load_jax_params(copy.deepcopy(tmodel), jgrads)
    jafter = load_jax_params(copy.deepcopy(tmodel), jnew["params"])
    named = dict(tmodel.named_parameters())
    assert len(named) == len(trainer.params)
    n_compared = n_total = 0
    for (name, want_g), (_, want_p), p0 in zip(gmod.named_parameters(),
                                               jafter.named_parameters(), before):
        p = named[name]
        g, wg = p.grad.numpy(), want_g.detach().numpy()
        scale = np.abs(wg).max()
        np.testing.assert_allclose(g, wg, atol=2e-4 * scale + 1e-8, rtol=0, err_msg=name)
        noise = np.abs(wg) < 2e-3 * scale + 1e-8
        delta, want_delta = (p.detach() - p0).numpy(), (want_p.detach() - p0).numpy()
        np.testing.assert_allclose(np.where(noise, 0, delta), np.where(noise, 0, want_delta),
                                   atol=1e-6, rtol=0, err_msg=name)
        n_compared += int((~noise).sum())
        n_total += noise.size
    assert n_compared >= 0.9 * n_total, (n_compared, n_total)


def test_nonfinite_step_leaves_state_unchanged(rng):
    """A non-finite loss skips the update: parameters, optimizer moments
    and count, and the normalization statistics keep their values; the
    step counter moves on."""
    _, tmodel, _ = tiny_models()
    trainer = _port_trainer(tmodel)
    state = trainer.init_state(seed=0)
    batch = {k: torch.from_numpy(v) for k, v in _batch(rng).items()}
    state, _ = trainer.train_step(state, batch)
    snap = ([p.detach().clone() for p in trainer.params],
            [m.clone() for m in state["opt_state"]["mu"]],
            int(state["opt_state"]["count"]),
            {k: v.clone() for k, v in state["norm_stats"].items()})
    bad = dict(batch, wav=batch["wav"].clone())
    bad["wav"][1, 100] = float("nan")
    new, metrics = trainer.train_step(state, bad)
    assert metrics["nonfinite_skipped"] == 1 and new["step"] == state["step"] + 1
    assert not np.isfinite(float(metrics["loss"]))
    for p, p0 in zip(trainer.params, snap[0]):
        assert torch.equal(p.detach(), p0)
    for m, m0 in zip(new["opt_state"]["mu"], snap[1]):
        assert torch.equal(m, m0)
    assert int(new["opt_state"]["count"]) == snap[2]
    for k, v in new["norm_stats"].items():
        assert torch.equal(v, snap[3][k])


def test_losses_match_jax(rng):
    """CTC (batchmean, with an impossible alignment: 3 frames for labels
    that need 4, which JAX clamps to a loss of 1e30) and the KL-divergence
    with and without label smoothing and a pad index, within 1e-5."""
    b, t, v = 3, 12, 7
    lp = jax.nn.log_softmax(jnp.asarray(rng.standard_normal((b, t, v)), jnp.float32), -1)
    in_len = np.array([12, 9, 3], np.int32)
    tgt = np.array([[1, 2, 2, 3], [4, 5, 0, 0], [1, 1, 2, 0]], np.int32)
    tgt_len = np.array([4, 2, 3], np.int32)
    tlp = _t(lp)
    for red in ("none", "batchmean", "sum"):
        want = jctc_loss(lp, jnp.asarray(in_len), jnp.asarray(tgt), jnp.asarray(tgt_len),
                         reduction=red)
        got = ctc_loss(tlp, torch.from_numpy(in_len), torch.from_numpy(tgt),
                       torch.from_numpy(tgt_len), reduction=red)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, err_msg=red)
    assert float(ctc_loss(tlp, torch.from_numpy(in_len), torch.from_numpy(tgt),
                          torch.from_numpy(tgt_len), reduction="none")[2]) == np.float32(1e30)
    seq = jax.nn.log_softmax(jnp.asarray(rng.standard_normal((b, 5, v)), jnp.float32), -1)
    toks = np.array([[3, 4, 2, 0, 0], [5, 2, 0, 0, 0], [1, 6, 6, 2, 0]], np.int32)
    lens = np.array([3, 2, 4], np.int32)
    for smoothing, pad_idx in ((0.0, None), (0.1, None), (0.1, 0)):
        want = jkldiv_loss(seq, jnp.asarray(toks), jnp.asarray(lens), smoothing, pad_idx)
        got = kldiv_loss(_t(seq), torch.from_numpy(toks), torch.from_numpy(lens), smoothing,
                         pad_idx)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_augment_transforms_match_jax_draws(rng):
    """The port's transforms given the JAX functions' own draws (from the
    same split keys) give the JAX outputs: speed perturbation, time warp,
    and time and frequency drops with padding."""
    key = jax.random.PRNGKey(3)
    wav = rng.standard_normal((3, 2000)).astype(np.float32)
    lens = np.array([2000, 1500, 900], np.int32)
    want_wav, want_len = jaug.speed_perturb_batch(key, jnp.asarray(wav), jnp.asarray(lens))
    choice = jax.random.randint(key, (3,), 0, 3)
    got_wav, got_len = taug.speed_perturb_apply(_t(wav), torch.from_numpy(lens),
                                                torch.from_numpy(np.array(choice)).long())
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got_wav.numpy(), np.asarray(want_wav), atol=1e-5)

    x = rng.standard_normal((3, 60, 16)).astype(np.float32)
    pad = (np.arange(60)[None, :] < np.array([60, 45, 30])[:, None]).astype(np.float32)
    k_c, k_w = jax.random.split(key)
    want = jaug.time_warp(key, jnp.asarray(x), jnp.asarray(pad), 5)
    got = taug.time_warp_apply(_t(x), _t(jax.random.uniform(k_c, (3,))),
                               torch.from_numpy(np.array(jax.random.randint(k_w, (3,), -5, 6))),
                               _t(pad), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    for axis, (lo, hi) in ((1, (4, 8)), (2, (2, 5))):
        k_len, k_start = jax.random.split(key)
        want = jaug.spectrogram_drop(key, jnp.asarray(x), jnp.asarray(pad), lo, hi, 3, axis=axis)
        lengths = np.array(jax.random.randint(k_len, (3, 3), lo, hi + 1))
        got = taug.spectrogram_drop_apply(_t(x), torch.from_numpy(lengths),
                                          _t(jax.random.uniform(k_start, (3, 3))), _t(pad),
                                          axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert not np.allclose(got.numpy(), x)


def test_xavier_overwrite_stds_match_jax():
    """Every >1-D parameter of the tiny recipe's `asr` (encoder, cell,
    cgMLP, decoder, embedding) gets the std the JAX package's
    `_torch_xavier_std` gives its flax leaf; the overwrite redraws them
    from the generator at that std and leaves the 1-D ones alone."""
    _, tmodel, params = tiny_models()
    stds = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, _torch_xavier_std(
            "/".join(str(p) for p in path), leaf.shape) if leaf.ndim > 1 else -1.0, np.float32),
        params["params"]["asr"])
    want = load_jax_params(copy.deepcopy(tmodel.asr), stds)
    before = {n: p.detach().clone() for n, p in tmodel.asr.named_parameters()}
    g = torch.Generator().manual_seed(0)
    xavier_normal_overwrite(tmodel.asr, g)
    n_checked = n_sampled = 0
    for (name, p), (_, w) in zip(tmodel.asr.named_parameters(), want.named_parameters()):
        if p.dim() > 1:
            assert xavier_std(p) == pytest.approx(float(w.detach().flatten()[0]), rel=1e-6), name
            assert not torch.equal(p, before[name])
            if p.numel() >= 2048:
                assert float(p.detach().std()) == pytest.approx(xavier_std(p), rel=0.1), name
                n_sampled += 1
            n_checked += 1
        else:
            assert torch.equal(p, before[name]), name
    assert n_checked >= 30 and n_sampled >= 10


def _plain_launch(module):
    """A stand-in for a kernel launch: the plain version on the bf16 launch
    weights, counted."""
    ref = (fused_summary.summary_mixing_reference if module is fused_summary
           else fused_csgu.convolution_branch_reference)

    def launch(x, pad, weights, extra, keep, keep_prob):
        launch.calls += 1
        return ref(x, pad, weights, extra, keep, keep_prob)
    launch.calls = 0
    return launch


def test_autograd_functions_fill_every_grad_after_an_eval_pass(rng, monkeypatch):
    """The modules' kernel route on the CPU, the launches replaced by the
    plain versions: an eval pass under no_grad (which fills the modules'
    cached launch weights) and then a training step with dropout. Every
    cell and cgMLP parameter gets a gradient through the Functions, equal
    to what autograd of the modules' CPU route with the same keep-masks
    gives; every launch and backward is counted."""
    _, tmodel, _ = tiny_models()
    for mod in tmodel.modules():    # the recipe's dropout everywhere
        if isinstance(mod, Dropout):
            mod.rate = 0.1
    launches = {m: _plain_launch(m) for m in (fused_summary, fused_csgu)}
    feats = _t(rng.standard_normal((2, 24, 80)))
    feat_len = torch.tensor([24, 17])
    tokens = torch.tensor([[1, 4, 5], [1, 7, 0]])

    def run(kernel_route):
        with monkeypatch.context() as mp:
            if kernel_route:
                for m in (fused_summary, fused_csgu):
                    mp.setattr(m, "_launch", launches[m])
                mp.setattr(fused_summary, "fused_summary_mixing", fused_summary.kernel_call)
                mp.setattr(fused_csgu, "fused_convolution_branch", fused_csgu.kernel_call)
                mp.setattr(tsm, "uses_kernel", lambda x: True)
                mp.setattr(tconv, "uses_kernel", lambda x: True)
                # the tiny float32 widths are not what the kernels take
                mp.setattr(fused_summary, "takes", lambda **config: True)
                mp.setattr(fused_csgu, "takes", lambda **config: True)
            set_dropout_generator(tmodel, torch.Generator().manual_seed(5))
            tmodel.eval()
            with torch.no_grad():
                tmodel(feats, feat_len, tokens)
            tmodel.train()
            for p in tmodel.parameters():
                p.grad = None
            out = tmodel(feats, feat_len, tokens)
            (out["ctc_log_probs"].sum() + out["seq_log_probs"].sum()).backward()
            return {n: p.grad.clone() for n, p in tmodel.named_parameters() if p.grad is not None}

    b0 = (fused_summary.fused_summary_mixing.backwards,
          fused_csgu.fused_convolution_branch.backwards)
    kernel_grads = run(True)
    assert [launches[m].calls for m in (fused_summary, fused_csgu)] == [4, 4]
    assert (fused_summary.fused_summary_mixing.backwards - b0[0],
            fused_csgu.fused_convolution_branch.backwards - b0[1]) == (2, 2)
    fused = [n for n, _ in tmodel.named_parameters()
             if ".mixer." in n or ".convolution_branch." in n]
    assert len(fused) == 2 * (10 + 8)
    for n in fused:
        assert n in kernel_grads and bool(kernel_grads[n].abs().sum() > 0), n
    # the CPU route runs the modules' own layers in float32, the Functions
    # the plain versions on bf16-cast weights: the same masks, another rounding
    plain_grads = run(False)
    assert set(plain_grads) == set(kernel_grads)
    for n in fused:
        scale = float(plain_grads[n].abs().max())
        torch.testing.assert_close(kernel_grads[n], plain_grads[n], rtol=0,
                                   atol=0.05 * scale + 1e-6, msg=n)


def _pad(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)


def test_masked_plain_versions_match_flax_math(rng):
    """The kernels' plain versions with a keep-mask against the flax
    modules' math with the same mask, float32: the cell's dropout on the
    concatenated [local, pooled] features, the CSGU's on res·gate."""
    b, t, d = 2, 9, 32
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    pad = _pad([9, 5], t)
    keep = rng.random((b, t, 32)) < 0.8
    act = functools.partial(jax.nn.gelu, approximate=True)
    cell = JSummaryMixing(enc_dim=d, nhead=1, local_proj_hid_dim=(24,), local_proj_out_dim=16,
                          summary_hid_dim=(24,), summary_out_dim=16, activation=act)
    params = cell.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def flax_cell(m, x, pad, keep):   # SummaryMixing._mix with the dropout's mask given
        p = pad[..., None]
        local = m.local_proj(x) * p
        summary = m.summary_proj(x) * p
        pooled = jnp.broadcast_to(jnp.sum(summary, 1, keepdims=True) / jnp.sum(p, 1, keepdims=True),
                                  summary.shape)
        cat = jnp.concatenate([local, pooled], -1)
        return m.summary_local_merging(jnp.where(keep, cat / 0.8, 0.0))
    want = cell.apply(params, jnp.asarray(x), jnp.asarray(pad), jnp.asarray(keep),
                      method=flax_cell)
    port = load_jax_params(tsm.SummaryMixing(d, 1, (24,), 16, (24,), 16, activation="gelu"),
                           params)
    got = fused_summary.summary_mixing_reference(_t(x), _t(pad)[..., None],
                                                 fused_summary.params_to_weights(port), "gelu",
                                                 torch.from_numpy(keep), 0.8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)
    assert not np.allclose(got.detach().numpy(), np.asarray(
        cell.apply(params, jnp.asarray(x), pad_mask=jnp.asarray(pad))), atol=1e-3)

    units, k = 32, 5
    bparams = {"pre_channel_proj": {"kernel": rng.standard_normal((d, units)) * 0.2,
                                    "bias": rng.standard_normal(units) * 0.1},
               "csgu": {"norm": {"scale": 1 + 0.3 * rng.standard_normal(units // 2),
                                 "bias": 0.3 * rng.standard_normal(units // 2)},
                        "conv_kernel": 0.3 * rng.standard_normal((k, units // 2)),
                        "conv_bias": 1 + 0.1 * rng.standard_normal(units // 2)},
               "post_channel_proj": {"kernel": rng.standard_normal((units // 2, d)) * 0.2,
                                     "bias": rng.standard_normal(d) * 0.1}}
    bparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), bparams)
    keep_c = rng.random((b, t, units // 2)) < 0.8
    bp, cp = bparams["pre_channel_proj"], bparams["csgu"]
    h = act(jnp.asarray(x) @ bp["kernel"] + bp["bias"])
    res, gate = jnp.split(h, 2, -1)
    mu, var = gate.mean(-1, keepdims=True), gate.var(-1, keepdims=True)
    gate = ((gate - mu) / jnp.sqrt(var + 1e-5) * cp["norm"]["scale"] + cp["norm"]["bias"])
    gate = jdepthwise(gate * jnp.asarray(pad)[..., None], cp["conv_kernel"], cp["conv_bias"])
    o = jnp.where(jnp.asarray(keep_c), res * gate / 0.8, 0.0)
    want = o @ bparams["post_channel_proj"]["kernel"] + bparams["post_channel_proj"]["bias"]
    branch = load_jax_params(tconv.ConvolutionBranch(d, units, k, activation="gelu"), bparams)
    got = fused_csgu.convolution_branch_reference(_t(x), _t(pad),
                                                  fused_csgu.branch_weights(branch),
                                                  keep=torch.from_numpy(keep_c), keep_prob=0.8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_augment,shuffle", [(1, False), (2, True)])
def test_spec_augment_applies_the_first_n_stages(rng, n_augment, shuffle):
    """The Augmenter's selection: with min = max = N the first N stages of
    [time drop, freq drop, time warp] run, in that order, or, shuffled, the
    first N of an order drawn before them; each from the same generator
    state as the stage run alone."""
    x = _t(rng.standard_normal((2, 40, 12)))
    pad = _t(_pad([40, 31], 40))
    cfg = taug.SpecAugmentConfig(time_drop_length=(3, 6), freq_drop_length=(2, 4),
                                 min_augmentations=n_augment, max_augmentations=n_augment,
                                 shuffle_augmentations=shuffle)
    got = taug.spec_augment(x, pad, cfg, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(7)
    order = torch.argsort(torch.rand(3, generator=g)).tolist() if shuffle else [0, 1, 2]
    want = x
    for stage in order[:n_augment]:
        if stage == 2:
            want = taug.time_warp_apply(want, *taug.time_warp_draw(g, 2, cfg.warp_window), pad,
                                        cfg.warp_window)
        else:
            count, lengths = ((cfg.time_drop_count, cfg.time_drop_length) if stage == 0
                              else (cfg.freq_drop_count, cfg.freq_drop_length))
            want = taug.spectrogram_drop_apply(
                want, *taug.spectrogram_drop_draw(g, 2, count, *lengths), pad, axis=stage + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, x)


def test_input_normalization_update_matches_jax(rng):
    """Running statistics over the valid frames of two batches, then frozen
    from the trainer's 0-based epoch 3 on (update_until_epoch 4), with
    the normalized features, against the JAX package's."""
    from summarymixing_tpu.frontend.features import InputNormalization as JNorm
    from summarymixing_tpu_torch.frontend.features import InputNormalization, NormStats

    jnorm, tnorm = JNorm(update_until_epoch=4), InputNormalization(update_until_epoch=4)
    jstats, tstats = JNormStats.init(6), NormStats.init(6)
    for epoch in (0, 1, 3):
        x = (rng.standard_normal((3, 9, 6)) * 4 + 2).astype(np.float32)
        pad = _pad([9, 5, 7], 9)
        jout, jstats = jnorm(jnp.asarray(x), jstats, jnp.asarray(pad), epoch=jnp.asarray(epoch),
                             update=True)
        tout, tstats = tnorm(_t(x), tstats, _t(pad), epoch=epoch, update=True)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
        for key in ("count", "mean", "m2"):
            np.testing.assert_allclose(tstats[key].numpy(), np.asarray(jstats[key]), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{key} at epoch {epoch}")
    assert float(tstats["count"]) == 9 + 5 + 7 + 9 + 5 + 7   # epoch 3 froze them


def test_build_trainer_reads_the_recipe():
    """`build_trainer` carries the recipe's training, augment, features and
    model fields into the trainer, read by the JAX package's own loader."""
    from summarymixing_tpu.config import load_recipe as jax_load_recipe
    from summarymixing_tpu_torch.config import build_model, build_trainer, load_recipe
    from test_torch_decoder import RECIPE, TINY_DEC

    jcfg = jax_load_recipe(RECIPE, overrides=TINY_DEC)
    cfg = load_recipe(RECIPE, overrides=TINY_DEC)
    model, fbank = build_model(cfg, device="cpu")
    trainer = build_trainer(cfg, model, fbank)
    t, a, c, opt = jcfg.training, jcfg.augment, trainer.config, trainer.optimizer
    assert (c.ctc_weight, c.label_smoothing) == (t.ctc_weight, t.label_smoothing) == (0.3, 0.0)
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay, opt.max_grad_norm) == (
        *t.adam_betas, t.adam_eps, t.weight_decay, t.max_grad_norm)
    assert float(opt.schedule(t.n_warmup_steps)) == pytest.approx(t.lr_adam, rel=1e-6)
    assert float(opt.schedule(0)) == pytest.approx(
        float(joptim.noam_schedule(t.lr_adam, t.n_warmup_steps)(0)), rel=1e-6)
    assert c.speed_perturb == a.speed_perturb and tuple(c.speeds) == tuple(a.speeds)
    assert c.augment.time_drop_length == (a.time_drop_length_low, a.time_drop_length_high)
    assert c.augment.freq_drop_count == a.freq_drop_count
    assert c.augment.min_augmentations == a.min_augmentations == 3
    assert c.normalize_update_until_epoch == jcfg.features.normalize_update_until_epoch
    assert (c.blank_id, c.pad_id, c.bos_id, c.eos_id) == (
        jcfg.model.blank_index, jcfg.model.pad_index, jcfg.model.bos_index,
        jcfg.model.eos_index)


def test_eval_step_matches_jax(rng):
    """`eval_step` (frozen statistics, eval mode) against the JAX
    trainer's deterministic `_forward_loss` and greedy decode: losses within
    1e-5 relative, the same hypotheses."""
    from summarymixing_tpu.decoding.ctc import collapse_ctc, ctc_greedy_decode

    jmodel, tmodel, params = tiny_models()
    batch = _batch(rng)
    stats = {"count": np.float32(50.0), "mean": (rng.standard_normal(80) - 10).astype(np.float32),
             "m2": (49.0 * (1 + rng.random(80)) ** 2).astype(np.float32)}
    jtrainer = JTrainer(jmodel, joptim.make_adamw(joptim.noam_schedule(LR, WARMUP)),
                        JFbank(win_length_ms=32.0),
                        JTrainerConfig(ctc_weight=0.3, label_smoothing=0.0, augment=None),
                        mesh=make_mesh(devices=jax.devices()[:1]))
    fwd = jax.jit(jtrainer._forward_loss, static_argnums=(4,))
    _, (jlosses, _, out) = fwd(params["params"], {k: jnp.asarray(v) for k, v in stats.items()},
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(0), True, 0)
    want = collapse_ctc(*ctc_greedy_decode(out["ctc_log_probs"], out["enc_lengths"]))
    trainer = _port_trainer(tmodel)
    state = dict(trainer.init_state(seed=0), norm_stats={k: _t(v) for k, v in stats.items()})
    losses, hyps = trainer.eval_step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ("loss", "ctc", "att"):
        np.testing.assert_allclose(float(losses[key]), float(jlosses[key]), rtol=1e-5,
                                   err_msg=key)
    assert hyps == want and any(want)
