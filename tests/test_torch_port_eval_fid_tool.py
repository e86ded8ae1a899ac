"""Evaluation in the port against the JAX package, part 3: the FID tool
(``python -m dmme_tpu_torch.fid`` against ``scripts/fid.py``), on the
fixtures of tests/torch_port_eval_common.py.
"""

import sys

import numpy as np
import pytest
import torch

import scripts.fid as jax_fid_tool
from dmme_tpu.eval import inception as jinc
from dmme_tpu_torch import fid as fid_tool
from tests.torch_port_eval_common import (F32_CANCEL_RTOL, SELF_FID_FLOOR,  # noqa: F401
                                          _close, _jax_feature_fn, image_sets, twin)

torch.set_num_threads(1)


# ---------------------------------------------------------------- the FID tool
def _tool_fid(tool, capsys, argv, **kw):
    tool(argv, **kw)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert out.startswith("FID: ")
    return float(out.split()[-1])


def _both_tools(capsys, monkeypatch, argv):
    monkeypatch.setattr(jinc, "make_feature_fn", _jax_feature_fn)
    got = _tool_fid(fid_tool.main, capsys, argv, device="cpu")
    return got, _tool_fid(jax_fid_tool.main, capsys, argv)


@pytest.mark.parametrize("pair", [("a.npy", "a.npy"), ("a_png", "a_q.npy")])
def test_fid_tool_same_pixels_score_zero_as_jax(image_sets, twin, capsys, monkeypatch, pair):
    argv = [str(image_sets / p) for p in pair] + ["--batch-size", "4",
                                                  "--weights", twin["fid"][1]]
    got, want = _both_tools(capsys, monkeypatch, argv)
    assert abs(got) < SELF_FID_FLOOR and abs(got - want) < SELF_FID_FLOOR


def test_fid_tool_stats_files_give_the_analytic_fid(capsys, monkeypatch, tmp_path):
    d = 8
    rng = np.random.RandomState(3)
    mu1, mu2 = rng.rand(d), rng.rand(d)
    s1, s2 = rng.rand(d) + 0.5, rng.rand(d) + 0.5
    p1, p2 = str(tmp_path / "s1.npz"), str(tmp_path / "s2.npz")
    np.savez(p1, mu=mu1, sigma=np.diag(s1))
    np.savez(p2, mu=mu2, sigma=np.diag(s2))
    want = float(np.sum((mu1 - mu2) ** 2) + np.sum(s1 + s2 - 2 * np.sqrt(s1 * s2)))
    got, jax_got = _both_tools(capsys, monkeypatch, [p1, p2])
    assert got == pytest.approx(want, rel=1e-5) and got == jax_got


def test_fid_tool_save_stats_round_trips(image_sets, twin, capsys, monkeypatch, tmp_path):
    root = str(image_sets)
    weights = ["--batch-size", "4", "--weights", twin["fid"][1]]
    stats = str(tmp_path / "a_stats.npz")
    fid_tool.main([f"{root}/a.npy", "--save-stats", stats, *weights], device="cpu")
    capsys.readouterr()
    d = np.load(stats)
    assert d["mu"].shape == (2048,) and d["sigma"].shape == (2048, 2048)
    got, want = _both_tools(capsys, monkeypatch, [stats, f"{root}/b.npy", *weights])
    direct = _tool_fid(fid_tool.main, capsys, [f"{root}/a.npy", f"{root}/b.npy", *weights],
                       device="cpu")
    assert got == direct and got > 10 * SELF_FID_FLOOR
    _close(got, want, F32_CANCEL_RTOL)


def test_fid_tool_names_pil_when_it_is_missing(image_sets, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL"):
        next(fid_tool._iter_batches(str(image_sets / "a_png"), 4))
