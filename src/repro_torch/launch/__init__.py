"""Step builders of the port (counterpart of ``repro/launch``): prefill
and single-token decode over the dense KV cache."""
