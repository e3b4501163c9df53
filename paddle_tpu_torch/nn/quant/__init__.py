"""paddle.nn.quant: an empty namespace, as in the reference (its
quantisation-aware training lives in slim, ROADMAP A13)."""
__all__ = []
