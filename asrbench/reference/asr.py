"""Plain float32 reference of the Branchformer CTC/attention recognizer that
the benchmark's configurations run: Fbank, global normalisation, the 2-D CNN
frontend, `src_proj` with the sine positions (or the relative-position table
of RelPosMHAXL), the Branchformer layers (SummaryMixing cell in full mode or
RelPosMHAXL, the cgMLP branch, the merge), the final norm, the CTC head; for
training the 6-layer attention decoder, CTC + KL losses, speed perturbation,
SpecAugment, dropout and AdamW with the Noam schedule.

It is written against the parameter layout of the system under test (the
names and `torch.nn.Linear` shapes of `param_shapes`) and imports nothing of
that system: every step is written out here in plain `torch` operations on
float32 tensors. Random draws (speed, SpecAugment, dropout keep-masks) are
made from a `torch.Generator` with the same calls in the same order as the
system makes them, so the same seed gives the same draws on the same device.

`Precision("float32")` is the reference; `Precision("fp8")` is the control:
every product (linear, convolution, attention) takes its operands rounded to
float8 e4m3 with one scale per tensor, as a float8 deployment would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

TOP_DB = 80.0
FP8_MAX = 448.0


class Precision:
    """The arithmetic of every product: float32 operands, or operands rounded
    to float8 e4m3 (one absmax scale per tensor), accumulated in float32."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(f"precision is float32 or fp8, got {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return t
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
        # the product sees the rounded operand; its gradient passes straight through
        return t + (rounded - t.detach())

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, self.q(a), self.q(b))


class Draws:
    """Keep-masks and augmentation draws from one generator (None: eval)."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.gen = generator

    def dropout(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        if self.gen is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen, device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros((), device=x.device))


# -- parameter layout ----------------------------------------------------------

def param_shapes(cfg: Dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter of the recognizer that the
    configuration `cfg` describes (its `model` section), in the system's
    naming."""
    m = cfg["model"]
    d, v = m["d_model"], m["output_neurons"]
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def lin(name, i, o, bias=True):
        out.append((f"{name}.weight", (o, i)))
        if bias:
            out.append((f"{name}.bias", (o,)))

    def norm(name, n):
        out.extend([(f"{name}.weight", (n,)), (f"{name}.bias", (n,))])

    chans, prev = m["frontend_channels"], 1
    for i, c in enumerate(chans):
        out += [(f"cnn.conv_{i}.weight", (c, prev, 3, 3)), (f"cnn.conv_{i}.bias", (c,))]
        norm(f"cnn.norm_{i}", c)
        prev = c
    lin("asr.src_proj", m["input_size"], d)
    units = m["csgu_linear_units"]
    for layer in range(m["num_encoder_layers"]):
        p = f"asr.encoder.layer_{layer}"
        if m["attention_type"] == "SummaryMixing":
            hl, ol = m["local_proj_hid_dim"][0], m["local_proj_out_dim"]
            hs, os_ = m["summary_hid_dim"][0], m["summary_out_dim"]
            lin(f"{p}.mixer.local_proj.layer_0", d, hl)
            lin(f"{p}.mixer.local_proj.layer_1", hl, ol)
            lin(f"{p}.mixer.summary_proj.layer_0", d, hs)
            lin(f"{p}.mixer.summary_proj.layer_1", hs, os_)
            lin(f"{p}.mixer.summary_local_merging.layer_0", ol + os_, os_)
            lin(f"{p}.merge_proj.layer_0", os_ + d, m["summary_hid_dim"][0])
            lin(f"{p}.merge_proj.layer_1", m["summary_hid_dim"][0], d)
        else:   # RelPosMHAXL
            h = m["nhead"]
            out += [(f"{p}.mixer.pos_bias_u", (h, d // h)), (f"{p}.mixer.pos_bias_v", (h, d // h))]
            for n in ("q_proj", "k_proj", "v_proj"):
                lin(f"{p}.mixer.{n}", d, d)
            lin(f"{p}.mixer.pos_proj", d, d, bias=False)
            lin(f"{p}.mixer.out_proj", d, d)
            lin(f"{p}.merge_proj", 2 * d, d)
        norm(f"{p}.norm_mhsa", d)
        cb = f"{p}.convolution_branch"
        lin(f"{cb}.pre_channel_proj", d, units)
        out += [(f"{cb}.csgu.conv_kernel", (m["csgu_kernel_size"], units // 2)),
                (f"{cb}.csgu.conv_bias", (units // 2,))]
        norm(f"{cb}.csgu.norm", units // 2)
        lin(f"{cb}.post_channel_proj", units // 2, d)
        norm(f"{p}.norm_conv", d)
    norm("asr.encoder.norm", d)
    if m["num_decoder_layers"] > 0:
        out.append(("asr.tgt_emb.emb.weight", (v, d)))
        for layer in range(m["num_decoder_layers"]):
            p = f"asr.decoder.layer_{layer}"
            for att in ("self_attn", "cross_attn"):
                for n in ("q_proj", "k_proj", "v_proj", "out_proj"):
                    lin(f"{p}.{att}.{n}", d, d)
            lin(f"{p}.pos_ffn.ffn_in", d, m["d_ffn"])
            lin(f"{p}.pos_ffn.ffn_out", m["d_ffn"], d)
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{p}.{n}", d)
        norm("asr.decoder.norm", d)
    lin("ctc_lin", d, v)
    if m["num_decoder_layers"] > 0:
        lin("seq_lin", d, v)
    return out


# -- features ----------------------------------------------------------------------

def windowed_basis(n_fft: int, win: int) -> np.ndarray:
    """`[win, 2·(n_fft//2+1)]`: the periodic Hamming window times [cos | sin] of
    the DFT, built in float64 and rounded to float32."""
    k = np.arange(n_fft // 2 + 1)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = -2.0 * np.pi * k * n / n_fft
    cos_b, sin_b = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    w = (0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(win) / win)).astype(np.float32)
    basis = np.concatenate([cos_b[:, :win], sin_b[:, :win]], axis=0) * w[None, :]
    return np.ascontiguousarray(basis.T.astype(np.float32))


def mel_filterbank(n_mels: int, n_fft: int, sr: int) -> np.ndarray:
    """Triangular HTK-mel filters `[n_fft//2+1, n_mels]` from 0 Hz to Nyquist."""
    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)

    mel = np.linspace(to_mel(0.0), to_mel(sr / 2), n_mels + 2)
    hz = 700.0 * (10.0 ** (mel / 2595.0) - 1.0)
    bins = np.linspace(0, sr / 2, n_fft // 2 + 1)
    fb = np.zeros((n_fft // 2 + 1, n_mels), np.float32)
    for i in range(n_mels):
        up = (bins - hz[i]) / max(hz[i + 1] - hz[i], 1e-10)
        down = (hz[i + 2] - bins) / max(hz[i + 2] - hz[i + 1], 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def fbank(wav: torch.Tensor, f: Dict) -> torch.Tensor:
    """wav `[B, N]` -> log-mel `[B, 1 + N//hop, n_mels]`, floored 80 dB below
    each row's peak."""
    sr, n_fft = f["sample_rate"], f["n_fft"]
    win, hop = round(sr * f["win_length"] / 1000), round(sr * f["hop_length"] / 1000)
    basis = torch.as_tensor(windowed_basis(n_fft, win), device=wav.device)
    mel_fb = torch.as_tensor(mel_filterbank(f["n_mels"], n_fft, sr), device=wav.device)
    n = wav.shape[1]
    t_out = 1 + n // hop
    half = win // 2
    right = max(0, (t_out - 1) * hop + win - n - half)
    frames = F.pad(wav.float(), (half, right)).unfold(1, win, hop)[:, :t_out]
    y = frames @ basis
    nf = n_fft // 2 + 1
    db = 10.0 * torch.log10((y[..., :nf] ** 2 + y[..., nf:] ** 2) @ mel_fb).clamp_min(-100.0)
    return torch.maximum(db, (db.amax(dim=(1, 2)) - TOP_DB)[:, None, None])


def frame_lengths(wav_lens: torch.Tensor, f: Dict) -> torch.Tensor:
    return 1 + wav_lens // round(f["sample_rate"] * f["hop_length"] / 1000)


def stats_update(stats: Dict, feats: Sequence[torch.Tensor], pads: Sequence[torch.Tensor]) -> Dict:
    """Chan's merge of the running (count, mean, m2) with the valid frames of
    every process's batch (`feats[p]` `[B, T, F]`, `pads[p]` `[B, T]`)."""
    ws = [p[..., None].float() for p in pads]
    n_b = sum(w.sum() for w in ws)
    mean_b = sum((x * w).sum(dim=(0, 1)) for x, w in zip(feats, ws)) / n_b.clamp_min(1.0)
    m2_b = sum((((x - mean_b) ** 2) * w).sum(dim=(0, 1)) for x, w in zip(feats, ws))
    n_a, mean_a = stats["count"], stats["mean"]
    n = n_a + n_b
    delta = mean_b - mean_a
    return {"count": n, "mean": mean_a + delta * n_b / n.clamp_min(1.0),
            "m2": stats["m2"] + m2_b + delta * delta * n_a * n_b / n.clamp_min(1.0)}


def normalize(feats: torch.Tensor, stats: Dict) -> torch.Tensor:
    std = torch.sqrt((stats["m2"] / (stats["count"] - 1.0).clamp_min(1.0)).clamp_min(1e-10))
    if float(stats["count"]) <= 0:
        return feats
    return (feats - stats["mean"]) / std


# -- layers ------------------------------------------------------------------------

def gelu(x: torch.Tensor, name: str) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if name == "gelu" else "none")


class Net:
    """The recognizer's forward over a dict of float32 parameters."""

    def __init__(self, w: Dict[str, torch.Tensor], m: Dict, prec: Precision, draws: Draws):
        self.w, self.m, self.prec, self.draws = w, m, prec, draws
        self.rate = float(m["transformer_dropout"]) if draws.gen is not None else 0.0

    def lin(self, x, name, bias=True):
        y = self.prec.einsum("...i,oi->...o", x, self.w[f"{name}.weight"])
        return y + self.w[f"{name}.bias"] if bias else y

    def norm(self, x, name, eps):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def drop(self, x):
        return self.draws.dropout(x, self.rate)

    def act(self, x):
        return gelu(x, self.m["activation"])

    # frontend and encoder
    def cnn(self, feats):
        x = feats[:, None]
        n = len(self.m["frontend_channels"])
        for i in range(n):
            x = F.conv2d(self.prec.q(x), self.prec.q(self.w[f"cnn.conv_{i}.weight"]),
                         self.w[f"cnn.conv_{i}.bias"], stride=2, padding=1)
            x = self.norm(x.permute(0, 2, 3, 1), f"cnn.norm_{i}", 1e-5)
            x = self.drop(F.leaky_relu(x, 0.01))
            if i + 1 < n:
                x = x.permute(0, 3, 1, 2)
        b, t, f, c = x.shape
        return x.reshape(b, t, f * c)

    def encode(self, feats, feat_len):
        """-> (encoder output `[B, T', D]`, lengths `[B]`, pad mask `[B, T']`)."""
        x = self.cnn(feats)
        t = x.shape[1]
        out_len = -(-(-(-feat_len // 2)) // 2)
        rel = out_len.float() / t
        valid = torch.round(rel * torch.tensor(float(t), device=x.device)).int()
        pad = (torch.arange(t, device=x.device)[None] < valid[:, None]).float()
        d = self.m["d_model"]
        x = self.drop(self.lin(x, "asr.src_proj"))
        pos = None
        if self.m["attention_type"] == "RelPosMHAXL":
            pos = sinusoids(torch.arange(t - 1, -t, -1, device=x.device).float(), d)
        else:
            x = x + sinusoids(torch.arange(t, device=x.device).float(), d)[None]
        for layer in range(self.m["num_encoder_layers"]):
            x = self.branchformer_layer(x, pad, pos, f"asr.encoder.layer_{layer}")
        return self.norm(x, "asr.encoder.norm", 1e-6), out_len, pad

    def branchformer_layer(self, x, pad, pos, p):
        h = self.norm(x, f"{p}.norm_mhsa", 1e-5)
        if self.m["attention_type"] == "SummaryMixing":
            x1 = self.drop(self.summary_mixing(h, pad, f"{p}.mixer"))
        else:
            x1 = self.drop(self.relpos_mha(h, pad, pos, f"{p}.mixer"))
        x2 = self.drop(self.cgmlp(self.norm(x, f"{p}.norm_conv", 1e-5), pad,
                                  f"{p}.convolution_branch"))
        cat = torch.cat([x1, x2], dim=-1)
        if self.m["attention_type"] == "SummaryMixing":
            merged = self.act(self.lin(self.act(self.lin(cat, f"{p}.merge_proj.layer_0")),
                                       f"{p}.merge_proj.layer_1"))
        else:
            merged = self.lin(cat, f"{p}.merge_proj")
        return x + self.drop(merged)

    def summary_mixing(self, x, pad, p):
        padm = pad[..., None]
        local = self.act(self.lin(self.act(self.lin(x, f"{p}.local_proj.layer_0")),
                                  f"{p}.local_proj.layer_1")) * padm
        summ = self.act(self.lin(self.act(self.lin(x, f"{p}.summary_proj.layer_0")),
                                 f"{p}.summary_proj.layer_1")) * padm
        pooled = (summ * padm).sum(dim=1, keepdim=True) / padm.sum(dim=1, keepdim=True)
        cat = self.drop(torch.cat([local, pooled.expand_as(summ)], dim=-1))
        return self.act(self.lin(cat, f"{p}.summary_local_merging.layer_0"))

    def cgmlp(self, x, pad, p):
        u = self.act(self.lin(x, f"{p}.pre_channel_proj"))
        res, gate = u.chunk(2, dim=-1)
        gate = self.norm(gate, f"{p}.csgu.norm", 1e-5) * pad[..., None]
        kern = self.w[f"{p}.csgu.conv_kernel"]
        k = kern.shape[0]
        left = (k - 1) // 2
        g = F.pad(gate.transpose(1, 2), (left, k - 1 - left))
        gate = F.conv1d(self.prec.q(g), self.prec.q(kern.t()[:, None, :]), None,
                        groups=gate.shape[-1]).transpose(1, 2) + self.w[f"{p}.csgu.conv_bias"]
        return self.lin(self.drop(res * gate), f"{p}.post_channel_proj")

    def attend(self, scores, allowed, v):
        """softmax over keys where `allowed` (bool, broadcast to the scores),
        dropout on the probabilities, then the weighted values `[B, T, H, hd]`."""
        scores = scores.masked_fill(~allowed, torch.finfo(torch.float32).min)
        probs = self.drop(torch.softmax(scores, dim=-1))
        return self.prec.einsum("bhts,bshd->bthd", probs, v)

    def relpos_mha(self, x, pad, pos, p):
        b, t, d = x.shape
        h = self.m["nhead"]
        hd = d // h
        q = self.lin(x, f"{p}.q_proj").reshape(b, t, h, hd)
        k = self.lin(x, f"{p}.k_proj").reshape(b, t, h, hd)
        v = self.lin(x, f"{p}.v_proj").reshape(b, t, h, hd)
        pp = self.lin(pos, f"{p}.pos_proj", bias=False).reshape(2 * t - 1, h, hd)
        content = self.prec.einsum("bthd,bshd->bhts", q + self.w[f"{p}.pos_bias_u"], k)
        rel = self.prec.einsum("bthd,phd->bhtp", q + self.w[f"{p}.pos_bias_v"], pp)
        # rel[..., i, j] holds relative position (t-1) - j; key s needs j = (t-1) - i + s
        idx = (t - 1) - torch.arange(t, device=x.device)[:, None] + torch.arange(
            t, device=x.device)[None, :]
        rel = torch.gather(rel, 3, idx[None, None].expand(b, h, t, t))
        scores = (content + rel) / math.sqrt(hd)
        ctx = self.attend(scores, (pad > 0)[:, None, None, :], v)
        return self.lin(ctx.reshape(b, t, d), f"{p}.out_proj")

    # heads and decoder
    def ctc_log_probs(self, enc):
        return torch.log_softmax(self.lin(enc, "ctc_lin"), dim=-1)

    def mha(self, xq, xkv, allowed, p):
        b, t, d = xq.shape
        s = xkv.shape[1]
        h = self.m["nhead"]
        q = self.lin(xq, f"{p}.q_proj").reshape(b, t, h, d // h)
        k = self.lin(xkv, f"{p}.k_proj").reshape(b, s, h, d // h)
        v = self.lin(xkv, f"{p}.v_proj").reshape(b, s, h, d // h)
        scores = self.prec.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d // h)
        return self.lin(self.attend(scores, allowed, v).reshape(b, t, d), f"{p}.out_proj")

    def decode(self, tokens_bos, enc, enc_pad):
        b, u = tokens_bos.shape
        d = self.m["d_model"]
        x = self.w["asr.tgt_emb.emb.weight"][tokens_bos] * math.sqrt(d)
        x = x + sinusoids(torch.arange(u, device=x.device).float(), d)[None]
        causal = torch.tril(torch.ones(u, u, dtype=torch.bool, device=x.device))
        self_ok = causal[None, None] & (tokens_bos != self.m["pad_index"])[:, None, None, :]
        cross_ok = (enc_pad > 0)[:, None, None, :]
        for layer in range(self.m["num_decoder_layers"]):
            p = f"asr.decoder.layer_{layer}"
            t1 = self.norm(x, f"{p}.norm1", 1e-6)
            x = x + self.drop(self.mha(t1, t1, self_ok, f"{p}.self_attn"))
            t1 = self.norm(x, f"{p}.norm2", 1e-6)
            x = x + self.drop(self.mha(t1, enc, cross_ok, f"{p}.cross_attn"))
            t1 = self.norm(x, f"{p}.norm3", 1e-6)
            ffn = self.lin(self.drop(self.act(self.lin(t1, f"{p}.pos_ffn.ffn_in"))),
                           f"{p}.pos_ffn.ffn_out")
            x = x + self.drop(ffn)
        x = self.norm(x, "asr.decoder.norm", 1e-6)
        return torch.log_softmax(self.lin(x, "seq_lin"), dim=-1)


def sinusoids(pos: torch.Tensor, dim: int) -> torch.Tensor:
    """`[len(pos), dim]`: sin(pos / 10000^(2i/d)) in even columns, cos in odd."""
    inv = torch.exp(torch.arange(0, dim, 2, device=pos.device).float() * -(math.log(10000.0) / dim))
    ang = pos[:, None] * inv[None]
    out = torch.zeros(pos.shape[0], dim, device=pos.device)
    out[:, 0::2] = torch.sin(ang)
    out[:, 1::2] = torch.cos(ang)
    return out


# -- decode ------------------------------------------------------------------------

@torch.no_grad()
def ctc_log_probs(w, cfg: Dict, stats: Dict, wav, wav_lens, prec: Precision = Precision()):
    """Greedy-decode input side: `(log-probs [B, T', V], lengths [B])` in eval mode."""
    net = Net(w, cfg["model"], prec, Draws(None))
    feats = normalize(fbank(wav, cfg["features"]), stats)
    enc, out_len, _ = net.encode(feats, frame_lengths(wav_lens, cfg["features"]))
    return net.ctc_log_probs(enc), out_len


def collapse(ids: torch.Tensor, lengths: torch.Tensor, blank: int = 0) -> List[List[int]]:
    """Per-frame ids `[B, T]` -> token lists: drop repeats, blanks and frames
    past each row's length."""
    out = []
    for row, n in zip(ids.cpu().tolist(), lengths.cpu().tolist()):
        toks, prev = [], None
        for i in row[:n]:
            if i != blank and i != prev:
                toks.append(i)
            prev = i
        out.append(toks)
    return out


# -- training ------------------------------------------------------------------------

def speed_perturb(wav, lens, speeds, gen, num_taps: int = 16):
    """Each row resampled at a drawn speed s/100 by Hann-windowed sinc
    interpolation into the same buffer; lengths ceil(len·100/s)."""
    b, n = wav.shape
    choice = torch.randint(0, len(speeds), (b,), generator=gen, device=wav.device)
    ratios = torch.tensor([s / 100.0 for s in speeds], device=wav.device)[choice]
    pos = torch.arange(n, device=wav.device).float()[None] * ratios[:, None]
    base = torch.floor(pos).long()
    frac = pos - base.float()
    taps = torch.arange(-num_taps // 2 + 1, num_taps // 2 + 1, device=wav.device)
    idx = torch.clamp(base[..., None] + taps, 0, n - 1)
    rel = taps.float() - frac[..., None]
    cutoff = torch.clamp(1.0 / ratios, max=1.0)[:, None, None]
    window = 0.5 + 0.5 * torch.cos(math.pi * rel / (num_taps // 2 + 1))
    kernel = cutoff * torch.sinc(cutoff * rel) * torch.where(rel.abs() <= num_taps // 2, window,
                                                             torch.zeros_like(window))
    out = (torch.gather(wav.float(), 1, idx.reshape(b, -1)).reshape(b, n, -1) * kernel).sum(-1)
    new_len = torch.clamp(torch.ceil(lens.float() / ratios).int(), max=n)
    return out * (torch.arange(n, device=wav.device)[None] < new_len[:, None]).float(), new_len


def _span_drop(x, pad, gen, count, lo, hi, axis):
    b, _, f = x.shape
    lengths = torch.randint(lo, hi + 1, (b, count), generator=gen, device=x.device,
                            dtype=torch.int32)
    starts_u = torch.rand(b, count, generator=gen, device=x.device)
    size = x.shape[axis]
    valid = (pad.sum(dim=1).int() if axis == 1 else
             torch.full((b,), size, dtype=torch.int32, device=x.device))
    starts = (starts_u * torch.clamp(valid[:, None] - lengths, min=1).float()).int()
    pos = torch.arange(size, device=x.device)[None, None]
    drop = ((pos >= starts[..., None]) & (pos < (starts + lengths)[..., None])).any(dim=1)
    drop3 = drop[:, :, None] if axis == 1 else drop[:, None, :]
    w = pad[..., None]
    fill = (x * w).sum(dim=(1, 2), keepdim=True) / torch.clamp(w.sum(dim=(1, 2), keepdim=True) * f,
                                                                min=1.0)
    return torch.where(w > 0, torch.where(drop3, fill, x), x)


def _time_warp(x, pad, gen, window):
    b, t, _ = x.shape
    center_u = torch.rand(b, generator=gen, device=x.device)
    shift = torch.randint(-window, window + 1, (b,), generator=gen, device=x.device,
                          dtype=torch.int32)
    valid = pad.sum(dim=1).int()
    lo = torch.clamp(valid // 2, max=window)
    c = (center_u * torch.clamp(valid - 2 * lo, min=1).float()).int() + lo
    c_new = c + torch.minimum(torch.maximum(shift, -(c - 1)), valid - 1 - c)
    pos = torch.arange(t, device=x.device)[None].float()
    cf, cnf, vf = c.float()[:, None], c_new.float()[:, None], valid.float()[:, None]
    left = pos * (cf / torch.clamp(cnf, min=1.0))
    right = cf + (pos - cnf) * (vf - 1 - cf) / torch.clamp(vf - 1 - cnf, min=1.0)
    src = torch.minimum(torch.clamp(torch.where(pos <= cnf, left, right), min=0.0), vf - 1.0)
    src = torch.where(pos < vf, src, pos)
    i0 = torch.floor(src).long()
    i1 = torch.clamp(i0 + 1, max=t - 1)
    frac = (src - i0.float())[..., None]
    g0 = torch.gather(x, 1, i0[..., None].expand(-1, -1, x.shape[2]))
    g1 = torch.gather(x, 1, i1[..., None].expand(-1, -1, x.shape[2]))
    return g0 * (1.0 - frac) + g1 * frac


def spec_augment(x, pad, a: Dict, gen):
    """Time drop, frequency drop, time warp, in that order (all three)."""
    x = _span_drop(x, pad, gen, a["time_drop_count"], a["time_drop_length_low"],
                   a["time_drop_length_high"], 1)
    x = _span_drop(x, pad, gen, a["freq_drop_count"], a["freq_drop_length_low"],
                   a["freq_drop_length_high"], 2)
    return _time_warp(x, pad, gen, a["time_warp_window"])


def joint_loss(cfg, ctc_lp, enc_len, seq_lp, tokens, token_lens):
    """ctc_weight · CTC (per-utterance NLL over its label count, batch mean;
    an impossible alignment counts 1e30) + (1 - ctc_weight) · NLL of the
    EOS-terminated targets (batch mean of per-utterance means)."""
    m, t = cfg["model"], cfg["training"]
    b, u = tokens.shape
    per = F.ctc_loss(ctc_lp.transpose(0, 1), tokens.long(), enc_len.long(), token_lens.long(),
                     blank=m["blank_index"], reduction="none", zero_infinity=True)
    valid = torch.arange(u, device=tokens.device)[None] < token_lens[:, None]
    repeats = ((tokens[:, 1:] == tokens[:, :-1]) & valid[:, 1:]).sum(dim=1)
    per = torch.where(enc_len < token_lens + repeats, torch.full_like(per, 1e30), per)
    ctc = (per / token_lens.clamp_min(1).float()).mean()
    padded = torch.cat([tokens, torch.full((b, 1), m["pad_index"], dtype=tokens.dtype,
                                           device=tokens.device)], dim=1)
    pos = torch.arange(u + 1, device=tokens.device)[None]
    eos = torch.where(pos == token_lens[:, None], torch.full_like(padded, m["eos_index"]), padded)
    mask = (pos < (token_lens + 1)[:, None]).float()
    nll = -torch.gather(seq_lp, -1, eos[..., None].long())[..., 0] * mask
    att = (nll.sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)).mean()
    w = t["ctc_weight"]
    return w * ctc + (1.0 - w) * att


def noam_lr(step: int, peak: float, warmup: int) -> float:
    s = torch.tensor(float(max(step, 1)))
    w = torch.tensor(float(warmup))
    return float(peak * torch.sqrt(w) * torch.minimum(s ** -0.5, s * w ** -1.5))


class Trainer:
    """The training step over every process's batch at once: the mean of the
    processes' losses and gradients, normalisation statistics over all of
    their valid frames, each process's draws from its own generator.
    `count`: the optimizer steps already taken, which the schedule and the
    bias correction read, as the system's optimizer state is set."""

    def __init__(self, w: Dict[str, torch.Tensor], cfg: Dict, prec: Precision = Precision(),
                 count: int = 0):
        self.cfg, self.prec = cfg, prec
        self.names = [n for n, _ in param_shapes(cfg)]
        self.w = {n: w[n].detach().clone().float().requires_grad_(True) for n in self.names}
        self.mu = {n: torch.zeros_like(t) for n, t in self.w.items()}
        self.nu = {n: torch.zeros_like(t) for n, t in self.w.items()}
        self.count = count
        dev = next(iter(self.w.values())).device
        nm = cfg["features"]["n_mels"]
        self.stats = {"count": torch.zeros((), device=dev), "mean": torch.zeros(nm, device=dev),
                      "m2": torch.zeros(nm, device=dev)}

    def step(self, batches: Sequence[Dict], gens: Sequence[torch.Generator]):
        """One optimizer step; returns (mean loss, {name: gradient as clipped})."""
        cfg, m = self.cfg, self.cfg["model"]
        waves, feats, pads, lens = [], [], [], []
        for batch, gen in zip(batches, gens):
            wav, wl = speed_perturb(batch["wav"], batch["wav_lens"], cfg["augment"]["speeds"], gen)
            fe = fbank(wav, cfg["features"])
            fl = frame_lengths(wl, cfg["features"])
            feats.append(fe)
            lens.append(fl)
            pads.append((torch.arange(fe.shape[1], device=fe.device)[None] < fl[:, None]).float())
        self.stats = stats_update(self.stats, feats, pads)
        grads = {n: torch.zeros_like(t) for n, t in self.w.items()}
        total = 0.0
        for batch, gen, fe, pad, fl in zip(batches, gens, feats, pads, lens):
            x = spec_augment(normalize(fe, self.stats), pad, cfg["augment"], gen)
            net = Net(self.w, m, self.prec, Draws(gen))
            enc, enc_len, enc_pad = net.encode(x, fl)
            tokens = batch["tokens"]
            bos = torch.full((tokens.shape[0], 1), m["bos_index"], dtype=tokens.dtype,
                             device=tokens.device)
            seq_lp = net.decode(torch.cat([bos, tokens], dim=1), enc, enc_pad)
            loss = joint_loss(cfg, net.ctc_log_probs(enc), enc_len, seq_lp, tokens,
                              batch["token_lens"])
            g = torch.autograd.grad(loss, [self.w[n] for n in self.names], allow_unused=True)
            for n, gi in zip(self.names, g):
                if gi is not None:
                    grads[n] += gi
            total += float(loss.detach())
            del enc, seq_lp, loss, g
        k = len(batches)
        grads = {n: g / k for n, g in grads.items()}
        clipped = self._update(grads)
        return total / k, clipped

    @torch.no_grad()
    def _update(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        t = self.cfg["training"]
        b1, b2 = t["adam_betas"]
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())).float()
        scale = float(t["max_grad_norm"] / norm) if float(norm) >= t["max_grad_norm"] else 1.0
        lr = noam_lr(self.count, t["lr_adam"], t["n_warmup_steps"])
        self.count += 1
        clipped = {}
        for n, g in grads.items():
            g = g * scale
            clipped[n] = g
            self.mu[n].mul_(b1).add_(g * (1.0 - b1))
            self.nu[n].mul_(b2).add_(g * g * (1.0 - b2))
            mu_hat = self.mu[n] / (1.0 - b1 ** self.count)
            nu_hat = self.nu[n] / (1.0 - b2 ** self.count)
            upd = mu_hat / (torch.sqrt(nu_hat) + t["adam_eps"]) + t["weight_decay"] * self.w[n]
            self.w[n].sub_(lr * upd)
        return clipped
