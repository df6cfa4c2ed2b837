# Copyright The TorchMetrics-TPU contributors.
# Licensed under the Apache License, Version 2.0.
"""The port's copy of the versioned wire schema (counterpart of
``tests/unittests/serve/test_wire.py``): envelopes, frames, jsonable; and the
copy against the JAX package's, byte for byte."""
from __future__ import annotations

import json

import numpy as np
import pytest

from torchmetrics_tpu_torch.serve import wire


class TestEnvelopes:
    def test_ok_envelope_carries_version_and_fields(self):
        reply = wire.ok(stream="m1", next_seq=4)
        assert reply == {"v": wire.WIRE_VERSION, "ok": True, "stream": "m1", "next_seq": 4}

    def test_error_envelope_carries_code_message_and_extras(self):
        reply = wire.error("backpressure", "queue full", retry_after_s=0.05)
        assert reply["v"] == wire.WIRE_VERSION and reply["ok"] is False
        assert reply["error"]["code"] == "backpressure"
        assert reply["error"]["message"] == "queue full"
        assert reply["error"]["retry_after_s"] == 0.05

    def test_error_rejects_unknown_code(self):
        with pytest.raises(ValueError, match="unknown error code"):
            wire.error("not_a_code", "nope")

    def test_every_declared_code_builds(self):
        for code in wire.ERROR_CODES:
            assert wire.error(code, "x")["error"]["code"] == code


class TestFrames:
    def test_frame_round_trip(self):
        frame = wire.encode_frame({"op": "ingest", "seq": 3})
        assert frame.endswith(b"\n") and frame.count(b"\n") == 1
        assert wire.decode_frame(frame) == {"op": "ingest", "seq": 3}

    def test_decode_rejects_non_object(self):
        with pytest.raises(wire.WireError, match="JSON object"):
            wire.decode_frame(b"[1, 2]\n")

    def test_decode_rejects_garbage(self):
        with pytest.raises(wire.WireError):
            wire.decode_frame(b"{nope\n")


class TestVersion:
    def test_current_version_passes(self):
        wire.check_version({"v": wire.WIRE_VERSION, "op": "status"})

    def test_missing_version_rejected(self):
        with pytest.raises(wire.WireError, match="unsupported wire version"):
            wire.check_version({"op": "status"})

    def test_future_version_rejected(self):
        with pytest.raises(wire.WireError, match="unsupported wire version"):
            wire.check_version({"v": wire.WIRE_VERSION + 1})


class TestJsonable:
    def test_arrays_scalars_and_nests(self):
        obj = {
            "a": np.arange(3, dtype=np.float32),
            "b": np.float64(2.5),
            "c": [np.int32(1), (np.ones(2), "s")],
        }
        out = wire.to_jsonable(obj)
        assert out == {"a": [0.0, 1.0, 2.0], "b": 2.5, "c": [1, [[1.0, 1.0], "s"]]}
        json.dumps(out)  # actually serializable

    def test_float32_round_trip_is_bitwise(self):
        # wire batches are float32 → JSON binary64 → float32: bit-exact both ways
        vals = np.random.RandomState(0).rand(64).astype(np.float32)
        back = np.asarray(json.loads(json.dumps(wire.to_jsonable(vals))), dtype=np.float32)
        assert np.array_equal(back, vals)

    def test_wire_module_is_stdlib_only(self):
        # the ctl plane path-loads this module on jax-free supervisor hosts
        import torchmetrics_tpu_torch.serve.wire as mod

        import re

        src = open(mod.__file__).read()
        bad = re.findall(r"^\s*(?:import|from)\s+(jax|numpy|torchmetrics_tpu)\b", src, re.M)
        assert not bad, f"wire.py must stay stdlib-only (found imports of {bad})"


# ------------------------------------------- the copy against the JAX package's


class TestCopyOfJaxWire:
    """``torchmetrics_tpu_torch/serve/wire.py`` is a copy of the JAX
    package's: the same names and constants, and byte-equal output from every
    function over the same inputs, so the two packages speak one wire."""

    def test_constants_equal_jax(self):
        import torchmetrics_tpu.serve.wire as jwire

        assert wire.__all__ == jwire.__all__
        assert wire.WIRE_VERSION == jwire.WIRE_VERSION
        assert wire.ERROR_CODES == jwire.ERROR_CODES
        assert wire.ND_KEY == jwire.ND_KEY

    def test_code_equals_jax_but_docstrings(self):
        import ast
        import inspect

        import torchmetrics_tpu.serve.wire as jwire

        def bare(mod):
            tree = ast.parse(inspect.getsource(mod))
            for node in ast.walk(tree):
                body = getattr(node, "body", None)
                if isinstance(body, list) and body and isinstance(body[0], ast.Expr) and isinstance(
                    getattr(body[0], "value", None), ast.Constant
                ) and isinstance(body[0].value.value, str):
                    node.body = body[1:] or [ast.Pass()]
            return ast.dump(tree)

        assert bare(wire) == bare(jwire)

    def test_every_function_outputs_the_same_bytes(self):
        import torchmetrics_tpu.serve.wire as jwire

        tree = {
            "f32": np.arange(6, dtype=np.float32).reshape(2, 3),
            "i64": np.asarray([[7, -1]], dtype=np.int64),
            "b": np.asarray([True, False]),
            "scalar": np.float32(0.5),
            "blob": b"\x00\xff\x80kll",
            (3, 1): [np.float64(1.25), "text", None, 7, 2.5],
            "nested": {"rows": [np.asarray([1.5], dtype=np.float64)]},
        }
        for fn in ("to_jsonable", "encode_state"):
            got, want = getattr(wire, fn)(tree), getattr(jwire, fn)(tree)
            assert wire.encode_frame({"x": got}) == jwire.encode_frame({"x": want}), fn
        assert wire.encode_frame(wire.ok(a=1, b=[1.5])) == jwire.encode_frame(jwire.ok(a=1, b=[1.5]))
        for code in wire.ERROR_CODES:
            assert wire.error(code, "m", retry_after_s=0.05) == jwire.error(code, "m", retry_after_s=0.05)
        line = b'{"v":1,"op":"ingest","stream":"m1","seq":7,"batch":[[0.5],[1]]}\n'
        assert wire.decode_frame(line) == jwire.decode_frame(line)
        for bad in (b"[1]", b"{nope"):
            with pytest.raises(wire.WireError) as ours:
                wire.decode_frame(bad)
            with pytest.raises(jwire.WireError) as theirs:
                jwire.decode_frame(bad)
            assert str(ours.value) == str(theirs.value)
        for frame in ({"v": 1}, {"v": 2}, {}):
            outcome = []
            for mod in (wire, jwire):
                try:
                    mod.check_version(frame)
                    outcome.append(None)
                except ValueError as err:
                    outcome.append(str(err))
            assert outcome[0] == outcome[1], frame

    def test_serve_exports_equal_jax(self):
        import torchmetrics_tpu.serve as JS
        import torchmetrics_tpu.serve.factories as JF
        import torchmetrics_tpu_torch.serve as TS
        import torchmetrics_tpu_torch.serve.factories as TF

        assert TS.__all__ == JS.__all__ and len(TS.__all__) == 10
        assert TF.__all__ == JF.__all__ and len(TF.__all__) == 12
        for name in TS.__all__:
            assert hasattr(TS, name), name
        for name in TF.__all__:
            assert callable(getattr(TF, name)), name
        assert TS.wire.__name__ == "torchmetrics_tpu_torch.serve.wire"
