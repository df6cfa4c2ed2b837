# Clean twin of the ML009 fixtures: copies at the trust boundary.
# PINNED: no rule may fire here.
from typing import Any, Dict

import torch

from torchmetrics_tpu_torch.parallel import make_jit_update


def restore(metric: Any, payload: Dict[str, Any]) -> None:
    tree = {name: torch.tensor(v) for name, v in payload.items()}
    metric._install_state_tree(tree)


def run(metric: Any, buf: Any, batch: Any) -> Any:
    step, _state = make_jit_update(metric, donate=True)
    carry = {"total": torch.from_numpy(buf).clone(), "_update_count": torch.zeros((), dtype=torch.int32)}
    return step(carry, batch)
