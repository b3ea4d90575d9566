"""The parts of ``chip_smoke.py`` a CPU can check: phase selection, the
last-line format, failure handling, the refusal to run without a GPU,
and the host-side references."""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent.parent


class TestPhaseSelection:
    def test_default_runs_every_single_card_phase(self):
        assert cs.select_phases(None, False) == list(cs.PHASES)
        assert cs.MULTICHIP not in cs.select_phases(None, False)

    def test_subset_keeps_canonical_order(self):
        got = cs.select_phases("forecast, mnist_chebnet", False)
        assert got == ["mnist_chebnet", "forecast"]

    def test_unknown_phase_raises(self):
        with pytest.raises(ValueError, match="unknown phases"):
            cs.select_phases("mnist_chebnet,warp_drive", False)

    def test_multichip_runs_alone(self):
        assert cs.select_phases(None, True) == [cs.MULTICHIP]
        with pytest.raises(ValueError, match="only the four-card"):
            cs.select_phases("formats", True)

    def test_every_phase_has_a_function(self):
        assert set(cs.FUNCS) == set(cs.PHASES) | {cs.MULTICHIP}


class TestOutput:
    @pytest.mark.parametrize("count", [1, 4])
    def test_result_line_is_exactly_the_contract(self, count):
        dev = types.SimpleNamespace(platform="gpu",
                                    device_kind="NVIDIA H100 80GB HBM3")
        line = cs.result_line([dev] * count)
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
            "count": count}}
        assert line == json.dumps(json.loads(line))

    def test_failed_phase_is_reported_and_fails_the_run(self, capsys):
        def good(ctx):
            return {"err": "0"}

        def bad(ctx):
            raise AssertionError("boom")

        ok = cs.run_phases(["a", "b", "c"], {"a": good, "b": bad, "c": good},
                           None)
        out = capsys.readouterr()
        assert not ok
        assert "phase=a status=ok" in out.out
        assert "phase=b status=FAIL" in out.out
        assert "phase=c status=ok" in out.out  # later phases still run
        assert "boom" in out.err

    def test_all_phases_passing(self, capsys):
        assert cs.run_phases(["a"], {"a": lambda ctx: {}}, None)

    def test_check_enforces_tolerance(self):
        assert "<=" in cs.check("x", 1e-5, 1e-4, "why")
        with pytest.raises(AssertionError, match="tol"):
            cs.check("x", 1e-3, 1e-4, "why")
        with pytest.raises(AssertionError):
            cs.check("x", float("nan"), 1e-4, "why")


class TestNoAccelerator:
    def test_main_without_gpu_exits_nonzero_and_prints_no_result(
            self, capsys):
        assert cs.main(["--phases", "formats"]) == 2
        out = capsys.readouterr()
        assert '"ok"' not in out.out
        assert "no GPU" in out.err

    def test_script_alone_in_a_directory_fails(self, tmp_path):
        """Copied away from the repository, the script must fail and
        print no result (it runs nothing without the package)."""
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=tmp_path,
            capture_output=True, text=True, timeout=120,
            env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout

    def test_multichip_phase_refuses_other_device_counts(self):
        # The CPU test platform has 8 virtual devices.
        with pytest.raises(AssertionError, match="needs 4 devices"):
            cs.phase_multichip(cs.Ctx(side=64, scattered_n=100))


class TestReferences:
    def test_scipy_chain_matches_chebyshev_basis(self, small_graph):
        from cnn_graph_tpu.graphs.construction import chebyshev_basis

        _, L, L_rescaled = small_graph
        x = np.random.default_rng(0).normal(size=(L.shape[0], 3))
        for K in (1, 2, 5):
            want = chebyshev_basis(L_rescaled, x, K)[K - 1]
            np.testing.assert_allclose(cs.scipy_chain(L, x, K), want,
                                       atol=1e-10)

    def test_scattered_graph_shape(self):
        L = cs._scattered_graph(300, 64, 16, seed=0)
        assert L.shape == (300, 300)
        # kNN symmetrised by max: every node keeps at least k neighbours.
        deg = np.diff(L.tocsr().indptr) - 1  # minus the diagonal
        assert deg.min() >= 16
