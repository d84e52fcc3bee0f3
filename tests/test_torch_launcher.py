"""The one launcher every kernel wrapper calls, ``ops/_lib.launch``, on
the CPU: a stand-in library and device context record what it passes.
The arguments go as given and the device's current stream follows them
inside the device's context, ``ptr`` makes a tensor its data pointer
and no tensor a null pointer, a failed launch raises under the kernel's
name and is not counted, a host query takes no stream, and ``load``
takes its lock only until the library has loaded."""

import contextlib
import types

import pytest
import torch

from vbcs_tpu_torch.ops import _lib

STREAM = 0xC0FFEE


class FakeLib:
    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def vbcs_kernel(self, *args):
        self.calls.append(("vbcs_kernel", args))
        return self.rc

    def vbcs_error_string(self, rc):
        return b"an error"


@pytest.fixture
def card(monkeypatch):
    """The stand-in library, and the devices entered (with the stream
    handle's reads) in order."""
    lib, seen = FakeLib(), []

    @contextlib.contextmanager
    def device(d):
        seen.append(("enter", d))
        yield
        seen.append(("exit", d))

    def current_stream(d):
        seen.append(("stream", d))
        return types.SimpleNamespace(cuda_stream=STREAM)

    monkeypatch.setattr(_lib, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    return lib, seen


def kernel():
    def my_kernel():
        pass

    my_kernel.launches = 0
    return my_kernel


def test_launch_passes_the_arguments_then_the_stream(card):
    lib, seen = card
    k, dev = kernel(), torch.device("cuda", 3)
    a, b = torch.zeros(4), torch.ones(2, dtype=torch.float64)
    assert _lib.ptr(a) == a.data_ptr() and _lib.ptr(None) is None
    _lib.launch(k, "vbcs_kernel", dev, 7, _lib.ptr(a), _lib.ptr(None), 0.5, b.data_ptr())
    assert lib.calls == [("vbcs_kernel", (7, a.data_ptr(), None, 0.5, b.data_ptr(),
                                          STREAM))]
    assert seen == [("enter", dev), ("stream", dev), ("exit", dev)]
    assert k.launches == 1
    _lib.launch(k, "vbcs_kernel", dev)
    assert lib.calls[-1] == ("vbcs_kernel", (STREAM,)) and k.launches == 2


@pytest.mark.parametrize("name, want", [(None, "my_kernel"), ("probe x", "probe x")])
def test_a_failed_launch_raises_and_is_not_counted(card, name, want):
    lib, _ = card
    lib.rc = 700
    k = kernel()
    with pytest.raises(RuntimeError, match=rf"^{want} launch failed: CUDA error 700 "
                                           r"\(an error\)$"):
        _lib.launch(k, "vbcs_kernel", "cuda:0", 1, name=name)
    assert k.launches == 0


def test_a_host_query_takes_no_stream(card):
    lib, seen = card
    _lib.launch(None, "vbcs_kernel", "cuda:1", 5, None, name="grid")
    assert lib.calls == [("vbcs_kernel", (5, None))]
    assert seen == [("enter", "cuda:1"), ("exit", "cuda:1")]
    lib.rc = 2
    with pytest.raises(RuntimeError, match="^grid launch failed"):
        _lib.launch(None, "vbcs_kernel", "cuda:1", name="grid")


def test_load_takes_no_lock_once_loaded(monkeypatch):
    class Refuse:
        def __enter__(self):
            raise AssertionError("the lock was taken")

        def __exit__(self, *exc):
            return False

    lib = FakeLib()
    monkeypatch.setattr(_lib, "_lib", lib)
    monkeypatch.setattr(_lib, "_lock", Refuse())
    assert _lib.load() is lib
