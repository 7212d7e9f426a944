"""Optimizers on the port's nested-dict parameter trees: AdamW with a
cosine schedule, the aux-loss-free balance update and LoRA adapters. Port
of ``repro/optim`` (the cross-pod gradient compression is not ported)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: F401
                                     adamw_update, cosine_schedule,
                                     global_norm)
from repro_torch.optim.balance import apply_balance_update  # noqa: F401
from repro_torch.optim.lora import init_lora, merge_lora  # noqa: F401
