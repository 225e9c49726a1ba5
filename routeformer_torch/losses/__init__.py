"""Training losses of the port."""

from routeformer_torch.losses.future_discounted import (
    FutureDiscountedLoss,
    future_discounted_loss,
    resolve_discount_factor,
)

__all__ = ["FutureDiscountedLoss", "future_discounted_loss", "resolve_discount_factor"]
