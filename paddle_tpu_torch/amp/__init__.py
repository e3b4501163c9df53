"""paddle.amp: auto_cast (O1/O2 op lists), decorate and GradScaler."""
from .auto_cast import amp_guard, auto_cast, decorate
from .grad_scaler import AmpScaler, GradScaler

__all__ = ["auto_cast", "decorate", "GradScaler", "AmpScaler", "amp_guard"]
