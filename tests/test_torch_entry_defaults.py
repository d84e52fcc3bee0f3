"""The port's entry points run on the card unless the caller asks for
another device: each takes ``device`` with the default ``"cuda"`` (the
CPU tests pass ``device="cpu"``)."""

import inspect

import pytest

import vbcs_tpu_torch as vt
from vbcs_tpu_torch.plan import device_dp

ENTRY_POINTS = {
    "VBCOperator.from_csc": vt.VBCOperator.from_csc,
    "VBCOperator.from_host": vt.VBCOperator.from_host,
    "VBC2DOperator.from_csc": vt.VBC2DOperator.from_csc,
    "VBC2DOperator.from_host": vt.VBC2DOperator.from_host,
    "dp_partition_device": device_dp.dp_partition_device,
    "dp_partition_device_2d": device_dp.dp_partition_device_2d,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"
