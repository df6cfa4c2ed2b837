# A checkpoint restore that installs zero-copy views of the deserialized
# numpy payload: the metric then writes into memory the caller owns.
# PINNED: ML009 must fire here (and nothing else may).
from typing import Any, Dict

import torch


def _to_tensor(v: Any) -> Any:
    if isinstance(v, list):
        return [torch.from_numpy(x) for x in v]
    return torch.from_numpy(v)


def restore(metric: Any, payload: Dict[str, Any]) -> None:
    tree = {name: _to_tensor(v) for name, v in payload.items()}
    metric._install_state_tree(tree)


def restore_attr(metric: Any, name: str, buf: Any) -> None:
    setattr(metric, name, torch.as_tensor(buf))
