# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""String enums used across the port (counterpart of ``torchmetrics_tpu/utilities/enums.py``)."""
from __future__ import annotations

from enum import Enum
from typing import Callable, Optional


class EnumStr(str, Enum):
    """Case-insensitive string enum."""

    @staticmethod
    def _name() -> str:
        return "Task"

    @classmethod
    def from_str(cls, value: str, source: str = "Key") -> "EnumStr":
        try:
            return cls[value.replace("-", "_").upper()]
        except KeyError as err:
            valid = [str(m.value) for m in cls]
            raise ValueError(f"Invalid {cls._name()}: expected one of {valid}, but got {value}.") from err

    def __str__(self) -> str:
        return self.value.lower()

    def __hash__(self) -> int:
        return hash(self.value.lower())

    def __eq__(self, other: object) -> bool:
        other = other.value if isinstance(other, Enum) else str(other)
        return self.value.lower() == other.lower()


class DataType(EnumStr):
    """Input data format."""

    @staticmethod
    def _name() -> str:
        return "Data type"

    BINARY = "binary"
    MULTILABEL = "multi-label"
    MULTICLASS = "multi-class"
    MULTIDIM_MULTICLASS = "multi-dim multi-class"


class AverageMethod(EnumStr):
    """Averaging strategy."""

    @staticmethod
    def _name() -> str:
        return "Average method"

    MICRO = "micro"
    MACRO = "macro"
    WEIGHTED = "weighted"
    NONE = None  # type: ignore[assignment]
    SAMPLES = "samples"


class MDMCAverageMethod(EnumStr):
    """Multi-dim multi-class averaging."""

    GLOBAL = "global"
    SAMPLEWISE = "samplewise"


class ClassificationTask(EnumStr):
    """Classification task dispatch key."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoBinary(EnumStr):
    """Dispatch key of the families without a binary task (exact match)."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    MULTICLASS = "multiclass"
    MULTILABEL = "multilabel"


class ClassificationTaskNoMultilabel(EnumStr):
    """Dispatch key of the families without a multilabel task (Cohen's kappa)."""

    @staticmethod
    def _name() -> str:
        return "Classification"

    BINARY = "binary"
    MULTICLASS = "multiclass"


def _task_call(
    task: str, num_classes: Optional[int], num_labels: Optional[int], binary: Callable, multiclass: Callable, multilabel: Callable
):
    """The result of the call for ``task``, one of three zero-argument calls, after
    checking that the task's class or label count is an int."""
    task_enum = ClassificationTask.from_str(task)
    if task_enum == ClassificationTask.BINARY:
        return binary()
    if task_enum == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass()
    if task_enum == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel()
    raise ValueError(f"Not handled value: {task}")


def _literal_task_call(
    task: str,
    num_classes: Optional[int],
    num_labels: Optional[int],
    binary: Callable,
    multiclass: Callable,
    multilabel: Optional[Callable] = None,
):
    """The dispatch of the families whose JAX dispatchers compare ``task`` as a
    literal string (the fixed-point curve families, calibration error, hinge):
    the same checks in the same order, with their messages. Without
    ``multilabel`` the family has no multilabel task."""
    if task == "binary":
        return binary()
    if task == "multiclass":
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass()
    if multilabel is not None and task == "multilabel":
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel()
    tasks = "'binary', 'multiclass' or 'multilabel'" if multilabel is not None else "'binary', 'multiclass'"
    raise ValueError(f"Expected argument `task` to be one of {tasks} but got {task}")
