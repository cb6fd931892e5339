"""The seed's weights: every parameter of 2 or more dimensions drawn by its
fan-in, whatever its name ends in, and the benchmark's configurations' own
weights equal to the last bit to those drawn before that rule covered every
matrix (digests taken on the CPU with the earlier rule)."""

import hashlib
import math

import pytest

from asrbench import harness
from asrbench.tests.transducer_cell import TINY_CONFORMER, TRANSDUCER_RECIPE
from asrbench.yardstick.weights import _scale_shift, make_weights

SEED = 2**31 + 20
# sha256 over each leaf's name and float32 bytes, in the reference's order,
# at SEED on the CPU, drawn by the rule that gave 1/sqrt(fan in) only to
# names ending in `.weight`
DIGESTS = {
    "branchformer_summarymixing":
        "01eef7448b4acfd5412d67885a709f49243c8da93e9bb46e08533a9815b0d498",
    "branchformer_mha": "b940ad2b9056b4c43a626c3c0369ba481b2514257025b274cf8d70c2226f431d",
}
# each matrix whose name does not end in `.weight`, and its fan-in at full width
TRANSDUCER_MATRICES = [("asr.encoder.layer_0.convolution_module.conv_kernel", 31),
                       ("transducer.predictor.lstm.weight_ih", 999),
                       ("transducer.predictor.lstm.weight_hh", 512)]


def _digest(name: str) -> str:
    cfg = harness.load_config(name)
    shapes = harness.load_reference(cfg).param_shapes(cfg)
    w = make_weights(shapes, SEED, "cpu")
    h = hashlib.sha256()
    for n, _ in shapes:
        h.update(n.encode())
        h.update(w[n].numpy().tobytes())
    return h.hexdigest()


def test_seed_weights_of_the_configurations_are_unchanged():
    """One configuration after the other (each draw holds some 0.5 GB)."""
    assert {name: _digest(name) for name in DIGESTS} == DIGESTS


def _transducer(overrides):
    cfg = {"name": "transducer", "recipe": TRANSDUCER_RECIPE, "overrides": overrides}
    return harness.build_system(cfg, "meta").named_parameters()


@pytest.mark.parametrize("name, full_fan_in", TRANSDUCER_MATRICES)
def test_transducer_matrices_are_drawn_by_their_fan_in(name, full_fan_in):
    """The depthwise kernel `[C, 1, K]` and the LSTM's matrices: std
    1/sqrt(product of the dimensions after the first), read from the small
    transducer's draw, and so drawn at full width."""
    shapes = [(n, tuple(p.shape)) for n, p in _transducer(TINY_CONFORMER).items()]
    w = make_weights(shapes, SEED, "cpu")[name]
    assert abs(float(w.std()) * math.sqrt(math.prod(w.shape[1:])) - 1.0) < 0.1
    full = tuple(_transducer({})[name].shape)
    assert math.prod(full[1:]) == full_fan_in
    assert _scale_shift(name, full) == (1.0 / math.sqrt(full_fan_in), 0.0)


def test_named_exceptions_keep_their_draw():
    assert _scale_shift("asr.tgt_emb.emb.weight", (5000, 512)) == (1.0 / math.sqrt(512), 0.0)
    assert _scale_shift("x.csgu.conv_kernel", (31, 1536)) == (1.0 / math.sqrt(31), 0.0)
    assert _scale_shift("x.csgu.conv_bias", (1536,)) == (0.1, 1.0)
    for n in ("x.mixer.pos_bias_u", "x.mixer.pos_bias_v"):
        assert _scale_shift(n, (8, 64)) == (0.05, 0.0)
    assert _scale_shift("x.norm.weight", (512,)) == (0.1, 1.0)
    assert _scale_shift("x.lstm.bias", (2048,)) == (0.05, 0.0)
