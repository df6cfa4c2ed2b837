# A donating step (make_jit_update(..., donate=True) updates its carry in
# place) handed a carry that views a numpy buffer.
# PINNED: ML009 must fire here (and nothing else may).
from typing import Any

import torch

from torchmetrics_tpu_torch.parallel import make_jit_update


def run(metric: Any, buf: Any, batch: Any) -> Any:
    step, _state = make_jit_update(metric, donate=True)
    carry = {"total": torch.from_numpy(buf), "_update_count": torch.zeros((), dtype=torch.int32)}
    return step(carry, batch)
