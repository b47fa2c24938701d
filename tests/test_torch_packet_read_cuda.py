"""The façade's one host read of a fused frame (SlamSystem._read_packet)
on the card (marker `cuda`; skipped without one): the packet lands in the
pinned buffer before the host reads it, also when the system's device is
not the current one. On the machine with the card, which has no JAX for
tests/conftest.py to import:

    python -m pytest --noconftest tests/test_torch_packet_read_cuda.py -q
"""
import types

import pytest
import torch

from geoflowslam_tpu_torch.pipeline.system import SlamSystem

pytestmark = pytest.mark.cuda


def _slow_packet(device):
    """A 36-float packet at the end of ~0.2 s of queued work on
    `device`, so that a read which does not wait for it sees the buffer
    before the copy."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(4096, 4096, device=device, generator=g)
    for _ in range(60):
        x = torch.tanh(x @ x * (1.0 / 64.0))
    return x[0, :36].clone()


def _read_twice(device):
    holder = types.SimpleNamespace(_pkt_host=None, _pkt_event=None)
    got = []
    for _ in range(2):
        pkt = _slow_packet(device)
        got.append((SlamSystem._read_packet(holder, pkt), pkt.cpu()))
    for host, want in got:
        assert torch.equal(torch.from_numpy(host), want)


def test_packet_read_on_the_current_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _read_twice(torch.device("cuda", torch.cuda.current_device()))


def test_packet_read_on_a_non_current_device():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    _read_twice(torch.device("cuda", 1))
    assert torch.cuda.current_device() == 0
