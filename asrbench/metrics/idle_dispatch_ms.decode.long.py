"""`idle_dispatch_ms.decode` in the long-form cell, under a name of its own beside that
cell's own end-to-end metrics (`decode_audio_s_per_s.long`)."""

from asrbench.harness import load_reader

_BASE = load_reader("idle_dispatch_ms.decode")
MODULES = getattr(_BASE, "MODULES", ())
read = _BASE.read
