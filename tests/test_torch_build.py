"""The one C boundary of the port's kernels, ``ops/_build.launch``, on the CPU.

Each entry of a fake library is a real ctypes function pointer, as a loaded
``.so``'s entries are, whose C side is a Python callback: so the values
arrive through ctypes' own conversions, under the argument types ``launch``
declared. The card's stream and device context are stand-ins; nothing here
needs a GPU or ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import types

import pytest
import torch

from multi_task_breast_cancer_tpu_torch.ops import _build, launches
from multi_task_breast_cancer_tpu_torch.ops import hopper_kernels as hk

_PROBE = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_float, ctypes.c_void_p)
_EMPTY = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p)


class _FakeLibrary:
    """Entries named like a kernel library's; each call is recorded and
    returns ``self.err``."""

    def __init__(self, prototype, *names):
        self.calls, self.err, self._callbacks = [], 0, []
        for name in names:
            callback = prototype(lambda *values, name=name: self._call(name, values))
            self._callbacks.append(callback)  # keep the C side alive
            address = ctypes.cast(callback, ctypes.c_void_p).value
            setattr(self, name, ctypes.CDLL(None)._FuncPtr(address))

    def _call(self, name, values):
        self.calls.append((name, values))
        return self.err


@pytest.fixture
def card(monkeypatch):
    """A stand-in card: ``torch.cuda.device`` a no-op, the current stream
    a handle the test may change between calls."""
    state = types.SimpleNamespace(stream=0x5EED)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=state.stream))
    return state


def _library(monkeypatch, prototype, *names):
    lib = _FakeLibrary(prototype, *names)
    monkeypatch.setattr(_build, "library", lambda source: lib)
    return lib


def _counter():
    def wrapper():
        pass
    wrapper.launches = 0
    return wrapper


def test_values_arrive_as_pointers_null_stream_and_c_scalars(monkeypatch, card):
    lib = _library(monkeypatch, _PROBE, "probe_f32")
    x = torch.zeros(2, 3)
    _build.launch("src", "probe", "cpu", x, None, 7, 0.1, _build.STREAM,
                  dtype=torch.float32)
    assert lib.calls == [("probe_f32", (x.data_ptr(), None, 7,
                                        float(torch.tensor(0.1, dtype=torch.float32)),
                                        0x5EED))]
    assert list(lib.probe_f32.argtypes) == [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_void_p]
    assert lib.probe_f32.restype is ctypes.c_int


def test_each_entry_is_declared_once_and_reads_the_stream_at_each_call(monkeypatch, card):
    lib = _library(monkeypatch, _PROBE, "probe_f32", "probe_bf16")
    x = torch.zeros(4)
    _build.launch("src", "probe", "cpu", x, x, 1, 1.0, _build.STREAM, dtype=torch.float32)
    declared = lib.probe_f32.argtypes
    card.stream = 0xCA97  # a capture's side stream
    _build.launch("src", "probe", "cpu", x, None, 2, 2.0, _build.STREAM, dtype=torch.float32)
    assert lib.probe_f32.argtypes is declared
    assert [values[-1] for _, values in lib.calls] == [0x5EED, 0xCA97]
    assert lib.probe_bf16.argtypes is None  # the other dtype's entry: not bound yet
    _build.launch("src", "probe", "cpu", x, x, 3, 3.0, _build.STREAM, dtype=torch.bfloat16)
    assert lib.calls[-1][0] == "probe_bf16" and list(lib.probe_bf16.argtypes) == list(declared)


def test_a_success_counts_exactly_one(monkeypatch, card):
    _library(monkeypatch, _PROBE, "probe_f32")
    counter = _counter()
    x = torch.zeros(4)
    for n in (1, 2):
        _build.launch("src", "probe", "cpu", x, x, 1, 1.0, _build.STREAM,
                      dtype=torch.float32, counter=counter)
        assert counter.launches == n


def test_a_failed_launch_raises_naming_the_entry_and_counts_nothing(monkeypatch, card):
    lib = _library(monkeypatch, _PROBE, "probe_bf16")
    lib.err = 700  # cudaErrorIllegalAddress
    counter = _counter()
    plan = hk.streaming_plan(6, 16)
    x = torch.zeros(2, 3, 4, 4, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match=r"probe_bf16: CUDA launch failed with error 700 "
                                           r"at tensors \(2, 3, 4, 4\) torch.bfloat16, plan "
                                           r"NormPlan\(variant='streaming'"):
        _build.launch("src", "probe", "cpu", x, None, 1, 1.0, _build.STREAM,
                      dtype=torch.bfloat16, counter=counter, plan=plan)
    assert counter.launches == 0 and len(lib.calls) == 1


def test_a_value_with_no_c_type_raises_before_the_call(monkeypatch, card):
    lib = _library(monkeypatch, _PROBE, "probe_f32")
    with pytest.raises(TypeError, match="no C argument type for str"):
        _build.launch("src", "probe", "cpu", torch.zeros(1), None, "7", 1.0, _build.STREAM,
                      dtype=torch.float32)
    assert lib.calls == [] and lib.probe_f32.argtypes is None


def test_the_launch_floor_is_one_uncounted_call_on_the_current_stream(monkeypatch, card):
    lib = _library(monkeypatch, _EMPTY, "instance_norm_leaky_relu_empty")
    before = launches.snapshot()
    hk.empty_launch(torch.device("cpu"))
    assert lib.calls == [("instance_norm_leaky_relu_empty", (0x5EED,))]
    assert launches.since(before) == {}
