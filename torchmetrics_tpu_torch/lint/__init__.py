# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""metriclint for the port: AST-based static checks of the CUDA-graph
capture and state contracts the port's runtime assumes (counterpart of
``torchmetrics_tpu/lint``; the rule IDs are JAX's, so each rule's
counterpart is found by its number).

Rules
-----
- **ML001** every attribute assigned in ``update`` must be registered via
  ``add_state`` (or declared in ``_host_counters``).
- **ML002** no host read of a device tensor (``float()``, ``int()``,
  ``bool()``, ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``,
  ``if t:``) and no capture breaker (``torch.bincount``, ``nonzero``,
  ``unique``, ``masked_select``, boolean-mask indexing, ``repeat_interleave``
  with tensor repeats and no ``output_size``) in a captured body: the
  ``update`` of a metric the fused plan accepts and the functional update
  kernels. A branch under ``if _is_concrete(...)`` is host path.
- **ML003** ``add_state`` must pass a valid ``dist_reduce_fx`` literal and a
  default whose type (tensor vs list) matches the reduction.
- **ML004** no ``numpy`` ops on device tensors where a torch op exists.
- **ML005** no metrics stored in ``set``/``frozenset`` containers.
- **ML006** no unbounded ``cat``-list states on metrics claiming
  ``full_state_update = False``.
- **ML007** no fusion-ineligible metrics constructed inline in a
  ``MetricCollection`` (the static mirror of ``fusion_ineligibility``).
- **ML008** sliced-plane contract at ``SlicedPlan``/``.sliced()`` sites
  (``slice_table_size_reason``/``slice_key_reason`` applied statically).
- **ML009** values built by aliasing constructors (``torch.from_numpy``,
  ``as_tensor``, ``frombuffer``, ``from_dlpack``, ``np.frombuffer``) must not
  flow into state installs or ``make_jit_update(..., donate=True)`` steps.
- **ML010** import closure: no port module reaches jax or the JAX package at
  module level; the stdlib-only surfaces reach neither torch nor numpy.
- **ML011** the ML002/ML004 predicates walked through the call graph from
  the captured entries into their callees.
- **ML012** serve-plane lock discipline in ``serve/`` and ``obs/live.py``.
- **ML013** a float-prediction ``update`` with no ``domain_contract``.
- **ML014** (torch only) a reduction over a computed ``dim`` with no
  emptiness guard: ``Tensor.sum(dim=())`` reduces every dim.
- **ML015** (torch only) ``torch.prod``/``Tensor.prod`` on a device tensor:
  its kernel compiles at run time.

Suppress a finding with ``# metriclint: disable=ML00x -- reason`` on the
offending line (or the line above); whole files opt out of one rule with
``# metriclint: disable-file=ML00x -- reason``.

Run ``python -m torchmetrics_tpu_torch.lint`` (or the file path
``torchmetrics_tpu_torch/lint/__main__.py``, which loads this package by
path). This package imports only the standard library — no torch, numpy or
jax, and nothing else of the port — so it loads by file path anywhere.
"""
from . import engine  # noqa: F401
from .engine import (  # noqa: F401
    Violation,
    diff_against_baseline,
    fingerprint,
    lint_paths,
    load_baseline,
    summarize,
)
from .rules import EXPLANATIONS, RULES  # noqa: F401
