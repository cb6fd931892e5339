"""The yardstick's operation and byte counts against hand counts at a tiny
shape."""

import pytest

from asrbench.yardstick import counts

M = {"d_model": 4, "local_proj_hid_dim": [3], "local_proj_out_dim": 2, "summary_hid_dim": [5],
     "summary_out_dim": 6, "csgu_linear_units": 8, "csgu_kernel_size": 3,
     "attention_type": "SummaryMixing", "frontend_channels": [2, 3], "frontend_strides": [2, 2],
     "input_size": 6, "output_neurons": 7, "num_encoder_layers": 1, "num_decoder_layers": 1,
     "d_ffn": 5, "nhead": 1}
F = {"sample_rate": 1000, "n_fft": 8, "win_length": 8, "hop_length": 4, "n_mels": 3}


def test_cell_counts_by_hand():
    # b=2 rows, t=5 frames, 7 valid: products 4x3 + 3x2 + 4x5 + 5x6 + 2x6 per
    # valid frame, 6x6 per row
    flops, nbytes = counts.cell_call(M, 2, 5, 7)
    assert flops == 2 * 7 * (12 + 6 + 20 + 30 + 12) + 2 * 2 * 36
    weights = 12 + 6 + 20 + 30 + 8 * 6
    biases = 3 + 2 + 5 + 6 + 6
    assert nbytes == 2 * 5 * (4 * 2 + 4 + 6 * 2) + (weights + biases) * 2


def test_cgmlp_counts_by_hand():
    flops, nbytes = counts.cgmlp_call(M, 2, 5)
    assert flops == 2 * 10 * (4 * 8 + 4 * 4 + 4 * 3)
    assert nbytes == 10 * (2 * 4 * 2 + 4) + (32 + 16 + 12 + 8 + 4 + 12) * 2


def test_bound_is_the_larger_of_the_two():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_encoder_counts_by_hand():
    # 40 samples: 11 frames (hop 4); CNN 11x3 -> 6x2 -> 3x1; 3 encoder frames
    feat, model = counts.encoder_flops(M, F, 40)
    assert feat == 2 * 11 * (8 * 10 + 5 * 3)
    cnn = 2 * 6 * 2 * 2 * 9 * 1 + 2 * 3 * 1 * 3 * 9 * 2
    cell, _ = counts.cell_call(M, 1, 3, 3)
    layer = 2 * 3 * (32 + 16 + 12) + cell + 2 * 3 * ((6 + 4) * 5 + 5 * 4)
    assert model == cnn + 2 * 3 * 6 * 4 + layer + 2 * 3 * 4 * 7


def test_attention_counts_by_hand():
    m = dict(M, attention_type="RelPosMHAXL")
    _, model = counts.encoder_flops(m, F, 40)
    _, base = counts.encoder_flops(M, F, 40)
    cell, _ = counts.cell_call(M, 1, 3, 3)
    t, d = 3, 4
    att = (2 * t * 4 * d * d + 2 * (2 * t - 1) * d * d + 2 * t * t * d + 2 * t * (2 * t - 1) * d
           + 2 * t * t * d + 2 * t * 2 * d * d)
    assert model - base == att - cell - 2 * 3 * ((6 + 4) * 5 + 5 * 4)


def test_train_counts_three_times_the_model():
    feat, enc = counts.encoder_flops(M, F, 40)
    dec = counts.decoder_flops(M, 3, 5)
    d, u, t = 4, 5, 3
    assert dec == (2 * u * 4 * d * d + 4 * u * u * d + 2 * u * 2 * d * d + 2 * t * 2 * d * d
                   + 4 * u * t * d + 4 * u * d * 5) + 2 * u * d * 7
    assert counts.train_batch_flops(M, F, [40], [4]) == feat + 3 * (enc + dec)


def test_trace_reduction_by_hand():
    from asrbench.yardstick.trace import summarize_events

    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "asrbench::SummaryMixing", "ts": 0,
         "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 2, "dur": 1,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "ncclAllReduce", "ts": 10, "dur": 10,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 40, "dur": 5, "args": {}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 21, "dur": 18},
    ]
    s = summarize_events(ev)
    assert s.busy_s == pytest.approx(20e-6)          # [5, 20] and [40, 45]
    assert s.module_s == {"SummaryMixing": pytest.approx(10e-6)}
    assert s.nccl_s == pytest.approx(10e-6)
    assert s.device_ops[0] == ("k1", pytest.approx(15e-6))
    assert s.idle_gaps == [("aten::item", pytest.approx(20e-6))]
