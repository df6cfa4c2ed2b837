# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""``metricserve`` federation — two-tier fleet aggregation over merge states
(counterpart of ``torchmetrics_tpu/serve/federation.py``).

"Millions of users" means many leaf daemons whose states fold into one
fleet-wide answer. The fold itself is
the easy half — every state kind is mergeable under its declared
``dist_reduce_fx`` (SURVEY §3: distribution is sharding) — so this module
spends its complexity on the fleet's FAILURE modes, managed as states rather
than exceptions:

- **double counting** — a restarted leaf replays its unpersisted suffix, so a
  naive pull would fold the replayed prefix twice. Every leaf export is
  stamped with the leaf's per-boot **epoch** nonce and the applied-seq
  **watermark** of the serialized state; the aggregator keeps ONE slot per
  (leaf, stream) and replaces it wholesale (snapshot semantics, never
  increments), accepting a new epoch only once its watermark has caught up
  with the slot it would replace. A fold therefore never mixes two boots'
  windows and a replayed prefix dedups structurally.
- **partial outage** — one pull supervisor per leaf (timeout / retry /
  exponential-backoff-with-jitter, the :class:`SyncConfig` semantics)
  classifies each leaf ``fresh | lagging | unreachable | quarantined``; an
  unreachable leaf's last slots keep contributing (stale but correct) and the
  aggregate is annotated with ``fleet.coverage`` instead of failing.
- **corrupt deltas** — every pulled payload is decoded and then proven
  against a freshly built reference metric through the checkpoint
  validate-ALL-then-apply ladder *before any slot is touched*: a corrupt
  payload names the leaf, quarantines it (excluded from the fold until a
  clean pull heals it), and never half-folds.
- **aggregator loss** — validated slots are checkpointed through
  :class:`CheckpointStore`, so a SIGKILLed aggregator resumes its fold state
  without re-pulling history the leaves may no longer hold.

``/healthz`` is worst-leaf-floored: lagging → ``stalling``, unreachable or
quarantined → ``degraded`` with a reason naming the leaf and the coverage
fraction. Folding supports ``metric`` and ``collection`` streams; a
``sliced`` plan aggregates locally (its carry is not cross-leaf mergeable)
and is reported as a per-stream error instead of poisoning the rest.

Lock discipline (ML012): ``_lock`` guards only dict snapshots/assignment.
Pulls, payload validation, fold-state saves and registry writes all run
outside it; fold-state saves go through a single writer loop.

**Mixed fleets.** The leaf exports, the fold and the aggregate are the JAX
package's, so one fleet holds leaves of both packages and either package's
aggregator folds them: a spec naming a JAX factory path resolves to the
port's factory of the same path. The aggregator's reference metrics live on
its ``device`` (default ``"cuda"``). A ``"bfloat16"`` array marker decodes
without ``ml_dtypes`` too (``robustness/bf16.py``); where ``ml_dtypes``
imports it decodes exactly as the JAX package's does.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import threading
import urllib.error
import urllib.request
import uuid
from typing import Any, Dict, List, Optional, Tuple

from torchmetrics_tpu_torch.obs import counters as _obs_counters
from torchmetrics_tpu_torch.obs import live as _obs_live
from torchmetrics_tpu_torch.robustness.bf16 import BFLOAT16, bfloat16_array
from torchmetrics_tpu_torch.robustness.store import CheckpointStore
from torchmetrics_tpu_torch.robustness.sync_config import SyncConfig
from torchmetrics_tpu_torch.serve import wire
from torchmetrics_tpu_torch.serve.stream import resolve_target
from torchmetrics_tpu_torch.utilities.data import resolve_device
from torchmetrics_tpu_torch.utilities.exceptions import StateRestoreError

__all__ = [
    "FleetAggregator",
    "LEAF_STATES",
    "LEAF_STATE_CODES",
    "LEAF_HEALTH_CODES",
    "decode_state",
]

#: the managed leaf states (the fleet's classification)
LEAF_STATES = ("fresh", "lagging", "unreachable", "quarantined")

#: leaf state → numeric gauge code (``fleet.leaf.<name>.state``)
LEAF_STATE_CODES = {"fresh": 0, "lagging": 1, "unreachable": 2, "quarantined": 3}

#: leaf state → health-severity code (``fleet.leaf.<name>.health_state``,
#: the obs ladder: 0 ok, 1 stalling, 2 degraded, 3 stalled) — a lagging leaf
#: still contributes (stale slots), so it only *stalls*; an unreachable or
#: quarantined leaf degrades the fleet
LEAF_HEALTH_CODES = {"fresh": 0, "lagging": 1, "unreachable": 2, "quarantined": 2}

_FOLD_PAYLOAD_VERSION = 1
_SLOT_KEYS = ("epoch", "watermark", "fingerprint", "kind", "spec", "payload")


# ------------------------------------------------------------------- codec
def decode_state(value: Any) -> Any:
    """Inverse of :func:`torchmetrics_tpu_torch.serve.wire.encode_state`: rebuild
    exact-dtype ndarrays from ``{"__nd__": dtype, "shape": [...], "data"}``
    markers (ml_dtypes names like ``bfloat16`` included; ``bfloat16`` also
    without ml_dtypes, as the port's host bfloat16 leaf) so the strict
    restore ladder accepts the round-trip, and ``{"__bytes__": ...}`` back
    into bytes."""
    import numpy as np

    if isinstance(value, dict):
        if wire.ND_KEY in value:
            dtype = _resolve_dtype(str(value[wire.ND_KEY]))
            data = value.get("data")
            shape = tuple(int(d) for d in value.get("shape", ()))
            if dtype is BFLOAT16:
                return bfloat16_array(data, shape)
            return np.asarray(data, dtype=dtype).reshape(shape)
        if set(value) == {"__bytes__"}:
            return str(value["__bytes__"]).encode("latin-1")
        return {k: decode_state(v) for k, v in value.items()}
    if isinstance(value, list):
        return [decode_state(v) for v in value]
    return value


def _resolve_dtype(name: str) -> Any:
    import numpy as np

    try:
        return np.dtype(name)
    except TypeError:
        pass
    try:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))
    except ImportError:
        if name == BFLOAT16:
            return BFLOAT16  # decoded to the port's own host bfloat16 leaf
        raise StateRestoreError(f"state payload carries unknown dtype {name!r}") from None
    except (AttributeError, TypeError):
        raise StateRestoreError(f"state payload carries unknown dtype {name!r}") from None


# -------------------------------------------------------------------- fold
def _disable_dist(target: Any) -> None:
    """The fleet fold IS the distribution: reference metrics built for
    folding must never enter a cross-process collective (it would also
    deadlock the lockstep multiprocess scenarios)."""
    from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics

    for _path, m in _walk_metrics(target):
        m.distributed_available_fn = lambda: False


def _assert_finite_payload(node: Any, path: str = "checkpoint", in_sketch: bool = False) -> None:
    """Walk a decoded export checkpoint and refuse any float leaf carrying a
    non-finite value BEFORE it can be folded into the fleet aggregate — the
    federation face of the StateGuard poison probe: one leaf that propagated
    a NaN locally must quarantine here, not poison every downstream fold.

    Sketch payloads (``__sketch__``-marked) legitimately carry ±inf sentinels
    (KLL empty slots, reservoir empty tags), so inside them only NaN is a
    defect; everywhere else Inf is corruption too."""
    import numpy as np

    from torchmetrics_tpu_torch.robustness.spec import SKETCH_PAYLOAD_KEY

    if isinstance(node, dict):
        in_sketch = in_sketch or SKETCH_PAYLOAD_KEY in node
        for key, value in node.items():
            _assert_finite_payload(value, f"{path}.{key}", in_sketch)
        return
    if isinstance(node, (list, tuple)):
        for i, value in enumerate(node):
            _assert_finite_payload(value, f"{path}[{i}]", in_sketch)
        return
    if isinstance(node, np.ndarray) and np.issubdtype(node.dtype, np.floating):
        bad = np.isnan(node).any() if in_sketch else not np.isfinite(node).all()
        if bad:
            raise StateRestoreError(f"non-finite value in export state at {path}")


def _fold_metric(acc: Any, other: Any) -> None:
    """Fold ``other``'s state into ``acc`` under each state's declared
    ``dist_reduce_fx`` — ``mean`` states weighted by update counts, plain
    numeric host counters summed. Both must be the same deep structure
    (guaranteed upstream by the per-slot fingerprint check)."""
    from torchmetrics_tpu_torch.parallel.sharded import _walk_metrics, tree_merge

    for (path_a, ma), (path_b, mb) in zip(_walk_metrics(acc), _walk_metrics(other)):
        if path_a != path_b:
            raise StateRestoreError(
                f"fold walk diverged: {path_a!r} vs {path_b!r} — the leaves do not share a schema"
            )
        if mb._update_count == 0:
            continue
        if ma._update_count == 0:
            ma._install_state_tree(mb.state_tree(include_count=True))
        else:
            merged = tree_merge(
                ma._reductions,
                ma.state_tree(include_count=False),
                mb.state_tree(include_count=False),
                weight_a=float(ma._update_count),
                weight_b=float(mb._update_count),
            )
            ma._install_state_tree(merged)
            ma._update_count += mb._update_count
        for attr in getattr(ma, "_host_counters", ()):
            va, vb = getattr(ma, attr, None), getattr(mb, attr, None)
            if isinstance(va, (int, float)) and not isinstance(va, bool) and isinstance(vb, (int, float)):
                setattr(ma, attr, va + vb)
        ma._computed = None


class FleetAggregator:
    """The aggregator tier: pulls per-stream state deltas from N leaf
    ``ServeDaemon``\\ s and folds them into one fleet-wide answer.

    Args:
        base_dir: durable root — ``leaves.json`` (the registry, restart
            fuel) and ``fold/`` (the :class:`CheckpointStore` of validated
            slots) live here.
        http: control-plane bind (``"host:port"`` / ``":port"`` / int);
            default ephemeral. Routes: ``/healthz``, ``/v1/fleet``,
            ``/v1/fleet/aggregate``, ``POST/DELETE /v1/fleet/leaves``.
        pull_interval_s: cadence of each leaf's pull supervisor (jittered so
            N supervisors never pull in lockstep).
        sync: retry/backoff policy per pull (the :class:`SyncConfig`
            semantics; jitter is added on every backoff sleep).
        fingerprint: optional registry fingerprint to pin every pull to —
            a leaf serving a different schema answers 409 and is quarantined
            instead of folded.
        checkpoint_every_s: fold-state persistence cadence (single writer
            loop; a save also runs at shutdown).
        publish: register the ``fleet.*`` gauges as a live-plane probe.
        keep_last: fold-store retention.
        device: where the reference metrics of the fold live (default
            ``"cuda"``; pass ``"cpu"`` to fold on the host).
    """

    def __init__(
        self,
        base_dir: str,
        http: Any = ":0",
        pull_interval_s: float = 1.0,
        sync: Optional[SyncConfig] = None,
        fingerprint: Optional[str] = None,
        checkpoint_every_s: float = 2.0,
        publish: bool = True,
        keep_last: Optional[int] = 3,
        device: Any = "cuda",
    ) -> None:
        self.base_dir = str(base_dir)
        self.device = resolve_device(
            device, "FleetAggregator", "Pass device='cpu' (or --device cpu) to fold on the CPU."
        )
        self._http_spec = http
        self.pull_interval_s = float(pull_interval_s)
        self.sync = sync if sync is not None else SyncConfig(timeout_s=5.0, retries=2, backoff_base_s=0.1)
        self.fingerprint = fingerprint
        self.checkpoint_every_s = float(checkpoint_every_s)
        self._publish = bool(publish)
        #: per-boot nonce — an aggregate answer names the aggregator boot
        #: that produced it, symmetric with the leaf epochs it folded
        self.epoch: Optional[str] = None
        self._leaves: Dict[str, Dict[str, Any]] = {}
        self._slots: Dict[str, Dict[str, Dict[str, Any]]] = {}  # leaf -> stream -> slot
        self._leaf_state: Dict[str, str] = {}
        self._leaf_reason: Dict[str, Optional[str]] = {}
        self._leaf_fails: Dict[str, int] = {}
        self._leaf_stops: Dict[str, threading.Event] = {}
        self._supervisors: Dict[str, threading.Thread] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._accepting = False
        self._dirty = False
        self._fold_seq = 0
        self._fold_store = CheckpointStore(
            os.path.join(self.base_dir, "fold"), keep_last=keep_last, write_rank=None
        )
        self._fold_thread: Optional[threading.Thread] = None
        self._http_server: Any = None
        self._http_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetAggregator":
        self.epoch = uuid.uuid4().hex[:12]
        os.makedirs(self.base_dir, exist_ok=True)
        self._load_registry()
        self._resume_fold_state()
        self._accepting = True
        if self._publish:
            _obs_live.register_probe("metricfleet", self._probe)
        self._start_http()
        with self._lock:
            names = sorted(self._leaves)
        for name in names:
            self._start_supervisor(name)
        self._fold_thread = threading.Thread(target=self._fold_loop, daemon=True, name="fleet-fold")
        self._fold_thread.start()
        return self

    def shutdown(self) -> None:
        """Stop supervisors, persist the fold state one last time, close the
        control plane. Restart = :meth:`start` on the same ``base_dir``."""
        self._accepting = False
        self._stop.set()
        with self._lock:
            stops = list(self._leaf_stops.values())
            threads = list(self._supervisors.values())
            fold_thread = self._fold_thread
        for stop in stops:
            stop.set()
        for thread in threads:
            thread.join(timeout=10.0)
        if fold_thread is not None:
            fold_thread.join(timeout=10.0)
        self._save_fold_state()
        if self._publish:
            _obs_live.unregister_probe("metricfleet")
        if self._http_server is not None:
            self._http_server.shutdown()
            self._http_server.server_close()
            if self._http_thread is not None:
                self._http_thread.join(timeout=10.0)
            self._http_server = self._http_thread = None

    # ------------------------------------------------------------- registry
    def _registry_path(self) -> str:
        return os.path.join(self.base_dir, "leaves.json")

    def _load_registry(self) -> None:
        try:
            with open(self._registry_path()) as fh:
                registry = json.load(fh)
        except (OSError, ValueError):
            return
        if not isinstance(registry, dict):
            return
        with self._lock:
            for name, url in registry.items():
                self._leaves[str(name)] = {"url": str(url)}
                self._leaf_state[str(name)] = "lagging"
                self._leaf_reason[str(name)] = "awaiting first pull"

    def _persist_registry(self, registry: Dict[str, str]) -> None:
        # atomic publish; concurrent add/remove handlers race benignly —
        # last writer wins with a complete snapshot, never a torn file
        data = json.dumps(registry, indent=2, sort_keys=True).encode()
        fd, tmp = tempfile.mkstemp(prefix="leaves.json.tmp-", dir=self.base_dir)
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(data)
            os.replace(tmp, self._registry_path())
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def add_leaf(self, name: str, url: str) -> Dict[str, Any]:
        """Register a leaf daemon by control-plane URL and start pulling."""
        if not self._accepting:
            return wire.error("draining", "aggregator is shutting down")
        if not name or "." in name or "/" in name:
            return wire.error("bad_request", f"leaf name {name!r} must be non-empty without '.' or '/'")
        with self._lock:
            if name in self._leaves:
                return wire.error("exists", f"leaf {name} is already registered")
            self._leaves[name] = {"url": str(url).rstrip("/")}
            self._leaf_state[name] = "lagging"
            self._leaf_reason[name] = "awaiting first pull"
            registry = {n: info["url"] for n, info in self._leaves.items()}
        self._persist_registry(registry)
        self._start_supervisor(name)
        return wire.ok(leaf=name, url=url)

    def remove_leaf(self, name: str) -> Dict[str, Any]:
        """Deregister a leaf; its slots leave the fold immediately."""
        with self._lock:
            if name not in self._leaves:
                return wire.error("not_found", f"no leaf named {name!r}")
            del self._leaves[name]
            self._slots.pop(name, None)
            self._leaf_state.pop(name, None)
            self._leaf_reason.pop(name, None)
            self._leaf_fails.pop(name, None)
            stop = self._leaf_stops.pop(name, None)
            thread = self._supervisors.pop(name, None)
            self._dirty = True
            registry = {n: info["url"] for n, info in self._leaves.items()}
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=5.0)
        self._persist_registry(registry)
        return wire.ok(leaf=name)

    def leaves(self) -> List[str]:
        with self._lock:
            return sorted(self._leaves)

    # ---------------------------------------------------------- supervision
    def _start_supervisor(self, name: str) -> None:
        stop = threading.Event()
        if self._stop.is_set():
            return
        thread = threading.Thread(
            target=self._supervise, args=(name, stop), daemon=True, name=f"fleet-pull-{name}"
        )
        with self._lock:
            if name not in self._leaves or name in self._supervisors:
                return
            self._leaf_stops[name] = stop
            self._supervisors[name] = thread
        thread.start()

    def _supervise(self, name: str, stop: threading.Event) -> None:
        while not stop.is_set() and not self._stop.is_set():
            try:
                self.pull_leaf(name, stop=stop)
            except Exception:
                _obs_counters.inc("fleet.pull_errors")
            # jittered cadence: N supervisors started together must not pull
            # (and retry) in lockstep against recovering leaves
            stop.wait(self.pull_interval_s + random.uniform(0.0, 0.25 * self.pull_interval_s))

    def pull_now(self) -> None:
        """One synchronous pull of every registered leaf (tests/benches use
        this for deterministic rounds instead of sleeping on the cadence)."""
        for name in self.leaves():
            try:
                self.pull_leaf(name)
            except Exception:
                _obs_counters.inc("fleet.pull_errors")

    def pull_leaf(self, name: str, stop: Optional[threading.Event] = None) -> None:
        """Pull, validate and (atomically) apply one leaf's state export."""
        with self._lock:
            info = self._leaves.get(name)
        if info is None:
            return
        stop = stop if stop is not None else self._stop
        body, failure = self._fetch_state(name, info["url"], stop)
        if body is None:
            if failure is not None:  # None failure == quarantined inside _fetch_state
                self._classify(name, "unreachable", failure)
            return
        _obs_counters.inc("fleet.pulls")
        epoch = str(body.get("epoch"))
        streams = body.get("streams")
        if not isinstance(streams, dict):
            self._classify(name, "quarantined", "state export carries no stream map")
            return
        candidates: List[Tuple[str, Dict[str, Any]]] = []
        lagging_reason: Optional[str] = None
        for sname in sorted(streams):
            env = streams[sname]
            if not isinstance(env, dict) or not env.get("ok"):
                err = (env or {}).get("error", {}) if isinstance(env, dict) else {}
                if err.get("code") == "fingerprint_mismatch":
                    self._classify(name, "quarantined", f"stream {sname}: {err.get('message')}")
                    return
                lagging_reason = f"stream {sname} export failed: {err.get('message', 'no envelope')}"
                continue
            try:
                candidates.append((sname, self._validated_slot(env, epoch)))
            except Exception as err:
                # validate-ALL-then-apply across the whole leaf: one corrupt
                # stream quarantines the pull and NOTHING from it is folded
                _obs_counters.inc("fleet.quarantined_payloads")
                self._classify(name, "quarantined", f"stream {sname} payload rejected: {err}")
                return
        replaying: List[str] = []
        with self._lock:
            if name not in self._leaves:
                return
            slots = self._slots.setdefault(name, {})
            for sname, slot in candidates:
                prev = slots.get(sname)
                if prev is None or int(slot["watermark"]) >= int(prev["watermark"]):
                    slots[sname] = slot
                elif slot["epoch"] != prev["epoch"]:
                    # the leaf restarted and is still replaying its suffix:
                    # keep the old boot's higher-watermark slot (dedup) until
                    # the new epoch catches up — a fold never mixes windows
                    replaying.append(sname)
                # same-epoch lower watermark: stale read, keep the newer slot
            self._dirty = True
        if replaying:
            self._classify(name, "lagging", f"restarted; replay behind on stream(s) {replaying}")
        elif lagging_reason is not None:
            self._classify(name, "lagging", lagging_reason)
        else:
            self._classify(name, "fresh", None)

    def _fetch_state(
        self, name: str, url: str, stop: threading.Event
    ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
        """GET ``<url>/v1/state`` under the SyncConfig retry policy. Returns
        ``(body, None)`` on success, ``(None, reason)`` after exhaustion, or
        ``(None, None)`` when the leaf was quarantined here (409)."""
        target = url.rstrip("/") + "/v1/state"
        if self.fingerprint:
            target += f"?fingerprint={self.fingerprint}"
        failure: Optional[str] = None
        for attempt in range(self.sync.attempts):
            if stop.is_set():
                return None, failure or "aggregator stopping"
            try:
                with urllib.request.urlopen(target, timeout=self.sync.timeout_s or 5.0) as resp:
                    return json.loads(resp.read()), None
            except urllib.error.HTTPError as err:
                try:
                    envelope = json.loads(err.read())
                except Exception:
                    envelope = None
                code = (envelope or {}).get("error", {}).get("code")
                if code == "fingerprint_mismatch":
                    self._classify(
                        name, "quarantined", envelope["error"].get("message", "fingerprint mismatch")
                    )
                    return None, None
                failure = f"HTTP {err.code} from {target}: {code or err.reason}"
            except (urllib.error.URLError, OSError, ValueError) as err:
                failure = f"{type(err).__name__}: {getattr(err, 'reason', err)}"
            if attempt + 1 < self.sync.attempts:
                # exponential backoff with jitter — a fleet of aggregator
                # retries must not thundering-herd a recovering leaf
                stop.wait(self.sync.backoff(attempt) + random.uniform(0.0, self.sync.backoff_base_s))
        return None, failure

    def _validated_slot(self, env: Dict[str, Any], epoch: str) -> Dict[str, Any]:
        """Decode one stream export and PROVE it against a fresh reference
        metric (the checkpoint's validate-ALL-then-apply ladder) before it can become
        a slot. Raises on any defect; never applies anything."""
        payload = decode_state(env.get("state"))
        if not isinstance(payload, dict) or "checkpoint" not in payload:
            raise StateRestoreError("export payload carries no checkpoint")
        _assert_finite_payload(payload["checkpoint"])
        watermark = env.get("watermark")
        if not isinstance(watermark, int) or watermark < 0:
            raise StateRestoreError(f"export watermark {watermark!r} is not a non-negative int")
        if payload.get("cursor") != watermark:
            raise StateRestoreError(
                f"export watermark {watermark} disagrees with payload cursor {payload.get('cursor')!r}"
            )
        kind = env.get("kind")
        spec = env.get("spec")
        if not isinstance(spec, dict) or not spec.get("target"):
            raise StateRestoreError("export carries no stream spec")
        if kind in ("metric", "collection"):
            self._build_loaded(spec, kind, payload["checkpoint"])  # raises on corruption
        elif kind != "sliced":
            raise StateRestoreError(f"unknown export kind {kind!r}")
        return {
            "epoch": epoch,
            "watermark": int(watermark),
            "fingerprint": env.get("fingerprint"),
            "kind": kind,
            "spec": {"target": spec["target"], "kwargs": spec.get("kwargs") or {}},
            "windowed": bool(env.get("windowed", False)),
            "payload": payload,
        }

    def _build_loaded(self, spec: Dict[str, Any], kind: str, checkpoint: Dict[str, Any]) -> Any:
        """Fresh reference target from the stream spec, loaded with
        ``checkpoint`` through the validate-ALL-then-apply ladder. The
        references never sync — the fleet fold IS the distribution."""
        from torchmetrics_tpu_torch.robustness.checkpoint import load_checkpoint

        target = resolve_target(spec["target"], spec.get("kwargs") or {}, device=self.device)
        if kind == "collection":
            from torchmetrics_tpu_torch.collections import MetricCollection

            if not isinstance(target, MetricCollection):
                raise StateRestoreError(
                    f"spec {spec['target']!r} builds a {type(target).__name__}, export says collection"
                )
            members = dict(target.items(keep_base=True, copy_state=False))
            if not isinstance(checkpoint, dict):
                raise StateRestoreError("collection checkpoint is not a member dict")
            missing = sorted(set(members) - set(checkpoint))
            extra = sorted(set(checkpoint) - set(members))
            if missing or extra:
                raise StateRestoreError(
                    "collection checkpoint does not match the spec:"
                    + (f" missing member(s) {missing}" if missing else "")
                    + (f" unexpected member(s) {extra}" if extra else "")
                )
            for mname, member in members.items():
                _disable_dist(member)
                load_checkpoint(member, checkpoint[mname])
        else:
            _disable_dist(target)
            load_checkpoint(target, checkpoint)
        return target

    def _classify(self, name: str, state: str, reason: Optional[str]) -> None:
        changed = False
        with self._lock:
            if name not in self._leaves:
                return
            if self._leaf_state.get(name) != state:
                changed = True
            self._leaf_state[name] = state
            self._leaf_reason[name] = reason
            if state == "unreachable":
                self._leaf_fails[name] = self._leaf_fails.get(name, 0) + 1
            elif state == "fresh":
                self._leaf_fails[name] = 0
        if changed:
            _obs_counters.inc(f"fleet.classify.{state}")

    # ----------------------------------------------------------------- fold
    def aggregate(self) -> Dict[str, Any]:
        """Fold every slot into the fleet-wide answer — sorted-leaf order per
        stream (cat states concatenate deterministically), ``mean`` states
        weighted by update counts, sketches through their union merge. A
        quarantined leaf is excluded; the answer is coverage-annotated."""
        with self._lock:
            slots_by_leaf = {leaf: dict(streams) for leaf, streams in self._slots.items()}
            leaf_state = dict(self._leaf_state)
            leaf_reason = dict(self._leaf_reason)
            registered = sorted(self._leaves)
            fold_seq = self._fold_seq
        per_stream: Dict[str, List[Tuple[str, Dict[str, Any]]]] = {}
        for leaf in sorted(slots_by_leaf):
            if leaf not in leaf_state or leaf_state.get(leaf) == "quarantined":
                continue
            for sname, slot in slots_by_leaf[leaf].items():
                per_stream.setdefault(sname, []).append((leaf, slot))
        results: Dict[str, Any] = {}
        errors: Dict[str, str] = {}
        for sname in sorted(per_stream):
            entries = per_stream[sname]
            kinds = sorted({str(slot["kind"]) for _, slot in entries})
            fingerprints = sorted({str(slot["fingerprint"]) for _, slot in entries})
            if len(kinds) > 1 or len(fingerprints) > 1:
                errors[sname] = (
                    f"leaves disagree on the stream schema: kinds={kinds} fingerprints={fingerprints}"
                )
                continue
            if kinds[0] not in ("metric", "collection"):
                errors[sname] = f"kind {kinds[0]!r} does not fold across leaves (sliced plans aggregate locally)"
                continue
            try:
                results[sname] = self._fold_stream(kinds[0], entries)
            except Exception as err:
                errors[sname] = f"fold failed: {type(err).__name__}: {err}"
        _obs_counters.inc("fleet.folds")
        covered = [l for l in registered if leaf_state.get(l) in ("fresh", "lagging")]
        return {
            "epoch": self.epoch,
            "fold_seq": fold_seq,
            "coverage": (len(covered) / len(registered)) if registered else 1.0,
            "leaves": {
                l: {"state": leaf_state.get(l, "lagging"), "reason": leaf_reason.get(l)}
                for l in registered
            },
            "streams": results,
            "errors": errors,
        }

    def _fold_stream(self, kind: str, entries: List[Tuple[str, Dict[str, Any]]]) -> Dict[str, Any]:
        acc = None
        folded: List[Dict[str, Any]] = []
        for leaf, slot in entries:  # already in sorted-leaf order
            inst = self._build_loaded(slot["spec"], kind, slot["payload"]["checkpoint"])
            if acc is None:
                acc = inst
            elif kind == "collection":
                a_members = dict(acc.items(keep_base=True, copy_state=False))
                b_members = dict(inst.items(keep_base=True, copy_state=False))
                for mname in sorted(a_members):
                    _fold_metric(a_members[mname], b_members[mname])
            else:
                _fold_metric(acc, inst)
            folded.append({"leaf": leaf, "epoch": slot["epoch"], "watermark": slot["watermark"]})
        return {
            "kind": kind,
            "value": wire.to_jsonable(acc.compute()),
            "windowed": any(slot.get("windowed") for _, slot in entries),
            "leaves": folded,
        }

    # ------------------------------------------------------ fold-state store
    def _fold_loop(self) -> None:
        # the SINGLE fold-state writer: supervisors only flip _dirty, so no
        # save ever runs under (or competes for) the slot lock
        while not self._stop.wait(self.checkpoint_every_s):
            self._save_fold_state()

    def _save_fold_state(self) -> None:
        with self._lock:
            if not self._dirty:
                return
            self._dirty = False
            self._fold_seq += 1
            seq = self._fold_seq
            slots = {leaf: dict(streams) for leaf, streams in self._slots.items()}
        payload = {"payload_version": _FOLD_PAYLOAD_VERSION, "fold_seq": seq, "slots": slots}
        try:
            self._fold_store.save(payload, step=seq)
        except Exception:
            _obs_counters.inc("fleet.fold_store_errors")

    def _resume_fold_state(self) -> None:
        last = self._fold_store.last_step()
        if last is not None:
            self._fold_seq = int(last)
        restored = self._fold_store.latest(validate=_validate_fold_payload)
        if restored is None:
            return
        _step, payload = restored
        with self._lock:
            for leaf, streams in payload["slots"].items():
                if leaf not in self._leaves:
                    continue  # removed while we were down: the registry wins
                self._slots[leaf] = dict(streams)
                self._leaf_state[leaf] = "lagging"
                self._leaf_reason[leaf] = "restored from fold checkpoint; awaiting first pull"

    # --------------------------------------------------------------- health
    def health(self) -> Dict[str, Any]:
        """Worst-leaf-floored fleet health with a coverage-annotated reason —
        computed from this aggregator's OWN classification, independent of
        any process-global live plane."""
        with self._lock:
            registered = sorted(self._leaves)
            leaf_state = dict(self._leaf_state)
            leaf_reason = dict(self._leaf_reason)
        state, reason = "ok", None

        def escalate(candidate: str, why: str) -> None:
            nonlocal state, reason
            if _obs_live._SEVERITY[candidate] > _obs_live._SEVERITY[state]:
                state, reason = candidate, why

        covered = sum(1 for l in registered if leaf_state.get(l, "lagging") in ("fresh", "lagging"))
        coverage = (covered / len(registered)) if registered else 1.0
        for leaf in registered:
            ls = leaf_state.get(leaf, "lagging")
            why = leaf_reason.get(leaf)
            if ls == "lagging":
                escalate("stalling", f"leaf {leaf} is lagging" + (f": {why}" if why else ""))
            elif ls in ("unreachable", "quarantined"):
                escalate(
                    "degraded",
                    f"leaf {leaf} is {ls}" + (f": {why}" if why else "")
                    + f" — fleet coverage {covered}/{len(registered)}, aggregate is partial",
                )
        return {
            "state": state,
            "reason": reason,
            "http_status": _obs_live.HEALTH_HTTP_STATUS[state],
            "epoch": self.epoch,
            "coverage": coverage,
            "leaves": {
                l: {"state": leaf_state.get(l, "lagging"), "reason": leaf_reason.get(l)}
                for l in registered
            },
        }

    def fleet_status(self) -> Dict[str, Any]:
        with self._lock:
            registered = sorted(self._leaves)
            leaves = {
                l: {
                    "url": self._leaves[l]["url"],
                    "state": self._leaf_state.get(l, "lagging"),
                    "reason": self._leaf_reason.get(l),
                    "failures": self._leaf_fails.get(l, 0),
                    "streams": {
                        sname: {"epoch": slot["epoch"], "watermark": slot["watermark"], "kind": slot["kind"]}
                        for sname, slot in sorted(self._slots.get(l, {}).items())
                    },
                }
                for l in registered
            }
            fold_seq = self._fold_seq
        covered = sum(1 for info in leaves.values() if info["state"] in ("fresh", "lagging"))
        return wire.ok(
            epoch=self.epoch,
            accepting=self._accepting,
            fold_seq=fold_seq,
            coverage=(covered / len(leaves)) if leaves else 1.0,
            leaves=leaves,
        )

    # ---------------------------------------------------------------- probe
    def _probe(self) -> Dict[str, float]:
        with self._lock:
            registered = sorted(self._leaves)
            leaf_state = dict(self._leaf_state)
            slot_counts = {l: len(self._slots.get(l, {})) for l in registered}
            fold_seq = self._fold_seq
        covered = sum(1 for l in registered if leaf_state.get(l, "lagging") in ("fresh", "lagging"))
        gauges: Dict[str, float] = {
            "fleet.leaves": float(len(registered)),
            "fleet.coverage": (covered / len(registered)) if registered else 1.0,
            "fleet.fold_seq": float(fold_seq),
        }
        for l in registered:
            ls = leaf_state.get(l, "lagging")
            gauges[f"fleet.leaf.{l}.state"] = float(LEAF_STATE_CODES[ls])
            gauges[f"fleet.leaf.{l}.health_state"] = float(LEAF_HEALTH_CODES[ls])
            gauges[f"fleet.leaf.{l}.streams"] = float(slot_counts.get(l, 0))
        return gauges

    # ----------------------------------------------------------------- http
    def http_address(self) -> Optional[Tuple[str, int]]:
        if self._http_server is None:
            return None
        return self._http_server.server_address[:2]

    def _start_http(self) -> None:
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        host, port = _obs_live._parse_http_spec(self._http_spec)
        agg = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args: Any) -> None:
                pass

            def _send_json(self, obj: Dict[str, Any], code: Optional[int] = None) -> None:
                if code is None:
                    code = 200 if obj.get("ok", True) else _ERROR_HTTP_STATUS.get(
                        obj.get("error", {}).get("code"), 400
                    )
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _route(self) -> None:
                path = self.path.split("?", 1)[0].rstrip("/")
                parts = [p for p in path.split("/") if p]
                try:
                    if self.command == "GET" and path == "/healthz":
                        health = agg.health()
                        self._send_json(health, code=health["http_status"])
                    elif self.command == "GET" and path == "/v1/fleet":
                        self._send_json(agg.fleet_status())
                    elif self.command == "GET" and path == "/v1/fleet/aggregate":
                        self._send_json(wire.ok(**agg.aggregate()))
                    elif parts[:3] == ["v1", "fleet", "leaves"]:
                        if self.command == "POST" and len(parts) == 3:
                            length = int(self.headers.get("Content-Length", 0))
                            body = wire.decode_frame(self.rfile.read(length)) if length else {}
                            self._send_json(agg.add_leaf(str(body.get("name")), str(body.get("url"))))
                        elif self.command == "DELETE" and len(parts) == 4:
                            self._send_json(agg.remove_leaf(parts[3]))
                        else:
                            self._send_json(wire.error("bad_request", f"{self.command} {self.path} not supported"))
                    else:
                        self._send_json(
                            wire.error(
                                "not_found",
                                "fleet control plane: /healthz, /v1/fleet, /v1/fleet/aggregate, /v1/fleet/leaves",
                            )
                        )
                except wire.WireError as err:
                    self._send_json(wire.error("bad_request", str(err)))
                except Exception as err:  # the control plane must answer, never hang up
                    self._send_json(wire.error("failed", f"{type(err).__name__}: {err}"), code=500)

            do_GET = do_POST = do_DELETE = _route

        self._http_server = ThreadingHTTPServer((host, port), _Handler)
        self._http_server.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._http_server.serve_forever, daemon=True, name="fleet-http"
        )
        self._http_thread.start()


def _validate_fold_payload(payload: Dict[str, Any]) -> None:
    """``CheckpointStore.latest`` hook for the aggregator's own fold state —
    structural validation only; every slot is re-proven through the full
    checkpoint ladder at the next fold anyway."""
    if payload.get("payload_version") != _FOLD_PAYLOAD_VERSION:
        raise StateRestoreError(
            f"fold-state payload_version {payload.get('payload_version')!r} is not supported"
        )
    slots = payload.get("slots")
    if not isinstance(slots, dict):
        raise StateRestoreError("fold-state payload carries no slot map")
    for leaf, streams in slots.items():
        if not isinstance(streams, dict):
            raise StateRestoreError(f"fold-state slots for leaf {leaf!r} are not a dict")
        for sname, slot in streams.items():
            missing = [k for k in _SLOT_KEYS if k not in slot]
            if missing:
                raise StateRestoreError(
                    f"fold-state slot {leaf}/{sname} is missing key(s) {missing} — truncated payload?"
                )


#: wire error code → HTTP status for the aggregator control plane
_ERROR_HTTP_STATUS = {
    "not_found": 404,
    "exists": 409,
    "draining": 503,
    "failed": 500,
    "bad_request": 400,
    "fingerprint_mismatch": 409,
}
