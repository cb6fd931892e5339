"""Training losses of the port: CTC and the label-smoothed KL divergence."""

from summarymixing_tpu_torch.losses.ctc import ctc_loss
from summarymixing_tpu_torch.losses.kldiv import kldiv_loss

__all__ = ["ctc_loss", "kldiv_loss"]
