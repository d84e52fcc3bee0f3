"""``tools/chain_probe_ab.py`` on the CPU: its arguments, its record's keys,
and its refusal to run without a card (a CPU clock is no device metric)."""

import pytest
import torch

from vbcs_tpu_torch.probes import probe_chain as pc
from vbcs_tpu_torch.tools import chain_probe_ab as ab


def test_sources_are_named(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    assert ab._named([f"old={src}"], "earlier") == [("old", "earlier", str(src))]
    for bad in (str(src), f"o-1={src}", f"old={tmp_path / 'missing.cu'}"):
        with pytest.raises(SystemExit):
            ab.main(["--earlier", bad])
    with pytest.raises(SystemExit):
        ab.main(["--bogus"])


def test_record_keys():
    names = ["package", "old"]
    rec = ab.variant_record("D", 2, {"package": 132, "old": 160},
                            {"package": 3e-3, "old": 1e-2}, {"package": 1e-7, "old": 1e-7},
                            {"package": ["old"], "old": ["package"]})
    assert set(rec) == {"variant", "wblk", "T", "n_lo", "n_hi", "builds"}
    assert (rec["variant"], rec["wblk"], rec["T"]) == ("D", 2, pc.T)
    assert (rec["n_lo"], rec["n_hi"]) == (pc.N_LO, pc.N_HI)
    assert list(rec["builds"]) == names
    for n in names:
        assert set(rec["builds"][n]) == {"blocks", "marginal_ms", "rel_err", "bitwise"}
    assert ab.ITERS == (1, 2, 3)


def test_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        ab.main([])
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        ab.main(["--earlier", f"old={src}", "--variant", f"new={src}"])
