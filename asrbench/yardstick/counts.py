"""Operations and bytes that the algorithm needs, from shapes.

Counts follow the mathematics, not an implementation: a product of an
`[n, k]` by a `[k, m]` operand is 2·n·k·m operations; each input and each
output byte is counted once. Peaks are NVIDIA's data-sheet numbers of one
H100 SXM (dense, no sparsity), valid at its full 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def cell_call(m: Dict, b: int, t: int, valid: int) -> Tuple[float, float]:
    """The full-mode SummaryMixing cell on `[b, t, d]` with `valid` unpadded
    frames: the local and summary MLPs and the merge's local half over the
    valid frames (a padded frame's local features are zero and its output is
    the row's pooled bias), the merge's pooled half once per row."""
    d, hl, ol = m["d_model"], m["local_proj_hid_dim"][0], m["local_proj_out_dim"]
    hs, os_ = m["summary_hid_dim"][0], m["summary_out_dim"]
    n = os_
    flops = 2.0 * valid * (d * hl + hl * ol + d * hs + hs * os_ + ol * n) + 2.0 * b * os_ * n
    weights = d * hl + hl * ol + d * hs + hs * os_ + (ol + os_) * n
    biases = hl + ol + hs + os_ + n
    nbytes = b * t * (d * BF16 + F32 + n * BF16) + (weights + biases) * BF16
    return flops, nbytes


def cgmlp_call(m: Dict, b: int, t: int) -> Tuple[float, float]:
    """The cgMLP branch on `[b, t, d]`: both projections and the depthwise
    convolution over every frame (the branch's output is defined on each)."""
    d, u, k = m["d_model"], m["csgu_linear_units"], m["csgu_kernel_size"]
    flops = 2.0 * b * t * (d * u + (u // 2) * d + (u // 2) * k)
    weights = d * u + (u // 2) * d + k * (u // 2)
    small = u + d + 3 * (u // 2)
    nbytes = b * t * (2 * d * BF16 + F32) + (weights + small) * BF16
    return flops, nbytes


def frames(samples: int, f: Dict) -> int:
    return 1 + samples // round(f["sample_rate"] * f["hop_length"] / 1000)


def _enc_frames(n_feat: int, strides: Sequence[int]) -> int:
    for s in strides:
        n_feat = -(-n_feat // s)
    return n_feat


def encoder_flops(m: Dict, f: Dict, samples: int) -> Tuple[float, float]:
    """(features, model) forward operations for one utterance of `samples`:
    the Fbank's DFT and mel products; the CNN, `src_proj`, every encoder
    layer and the CTC head over its own frames (attention over its own T²)."""
    win = round(f["sample_rate"] * f["win_length"] / 1000)
    nf = f["n_fft"] // 2 + 1
    fr = frames(samples, f)
    feat = 2.0 * fr * (win * 2 * nf + nf * f["n_mels"])
    chans, strides = m["frontend_channels"], m["frontend_strides"]
    t, mel, prev, cnn = fr, f["n_mels"], 1, 0.0
    for c, s in zip(chans, strides):
        t, mel = -(-t // s), -(-mel // s)
        cnn += 2.0 * t * mel * c * 9 * prev
        prev = c
    d, v = m["d_model"], m["output_neurons"]
    t = _enc_frames(fr, strides)
    u, k = m["csgu_linear_units"], m["csgu_kernel_size"]
    layer = 2.0 * t * (d * u + (u // 2) * d + (u // 2) * k)
    if m["attention_type"] == "SummaryMixing":
        cf, _ = cell_call(m, 1, t, t)
        hid = m["summary_hid_dim"][0]
        layer += cf + 2.0 * t * ((m["summary_out_dim"] + d) * hid + hid * d)
    else:
        layer += (2.0 * t * 4 * d * d + 2.0 * (2 * t - 1) * d * d       # q, k, v, out; pos
                  + 2.0 * t * t * d + 2.0 * t * (2 * t - 1) * d       # content, position scores
                  + 2.0 * t * t * d + 2.0 * t * 2 * d * d)            # values; merge
    model = cnn + 2.0 * t * m["input_size"] * d + m["num_encoder_layers"] * layer + 2.0 * t * d * v
    return feat, model


def decoder_flops(m: Dict, enc_t: int, u: int) -> float:
    """The attention decoder and its head over `u` positions (BOS included)
    against `enc_t` encoder frames."""
    d, v, ff = m["d_model"], m["output_neurons"], m["d_ffn"]
    layer = (2.0 * u * 4 * d * d + 4.0 * u * u * d            # self-attention
             + 2.0 * u * 2 * d * d + 2.0 * enc_t * 2 * d * d + 4.0 * u * enc_t * d   # cross
             + 4.0 * u * d * ff)
    return m["num_decoder_layers"] * layer + 2.0 * u * d * v


def decode_batch_flops(m: Dict, f: Dict, samples: Sequence[int]) -> float:
    return sum(sum(encoder_flops(m, f, n)) for n in samples)


def train_batch_flops(m: Dict, f: Dict, samples: Sequence[int], tokens: Sequence[int]) -> float:
    """Features once; encoder, decoder and both heads forward and backward
    (3x their forward). Speed perturbation changes lengths by at most 5%,
    which this count leaves out."""
    total = 0.0
    for n, u in zip(samples, tokens):
        feat, enc = encoder_flops(m, f, n)
        t = _enc_frames(frames(n, f), m["frontend_strides"])
        total += feat + 3.0 * (enc + decoder_flops(m, t, u + 1))
    return total
