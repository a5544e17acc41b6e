"""The port's SSIM duplicate finder (``data/ssim.py``) against the JAX
package's, on the CPU.

Same seeded images through both. Tolerances: SSIM values to 1e-5 absolute
(both are f32 'valid' convolutions with the same 11×11 window, summed in
other orders; SSIM lies in [-1, 1]); the groups, the report's pairs and the
curated CSV exactly (no pair of these images lies within 1e-5 of the
threshold). The sweep runs on ``cuda`` unless the CPU is asked for.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from multi_task_breast_cancer_tpu.data import ssim as jax_ssim
from multi_task_breast_cancer_tpu_torch.data import ssim

TOL = 1e-5


def _images(seed: int = 3, size: int = 32) -> tuple:
    """Two planted groups (a duplet and a triplet, copies with small noise),
    one exact copy in the triplet, and unrelated images; ids as BUSI's."""
    rng = np.random.default_rng(seed)
    base1, base2, *others = (rng.random((5, size, size)) * 255).astype(np.float32)
    noisy = lambda b: np.clip(b + rng.normal(0, 2, b.shape), 0, 255)  # noqa: E731
    imgs = np.stack([base1, noisy(base1), base2, noisy(base2), base2.copy(), *others])
    return imgs.astype(np.float32), [7, 3, 9, 12, 4, 20, 21, 22]


def test_ssim_pairwise_matches_jax():
    imgs, _ = _images()
    n = len(imgs)
    ii, jj = np.triu_indices(n, k=1)
    pairs = np.stack([ii, jj], axis=1)
    got = ssim.ssim_pairwise(imgs, pairs, chunk=5, device="cpu")
    want = jax_ssim.ssim_pairwise(imgs, pairs, chunk=5)
    assert got.dtype == np.float32 and got.shape == (len(pairs),)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert ssim.ssim(imgs[0], imgs[0], device="cpu") == pytest.approx(1.0, abs=TOL)


def test_find_duplicates_and_curation_match_jax(tmp_path):
    imgs, ids = _images()
    got = ssim.find_duplicates(imgs, threshold=0.9, chunk=7, device="cpu")
    want = jax_ssim.find_duplicates(imgs, threshold=0.9, chunk=7)
    assert got.groups == want.groups == [[2, 3, 4], [0, 1]]
    assert got.group_size_histogram() == want.group_size_histogram() == {3: 1, 2: 1}
    np.testing.assert_array_equal(got.ssim_matrix_pairs[:, :2], want.ssim_matrix_pairs[:, :2])
    np.testing.assert_allclose(got.ssim_matrix_pairs[:, 2], want.ssim_matrix_pairs[:, 2],
                               rtol=0, atol=TOL)

    classes = {"benign": (imgs, ids), "normal": (imgs[5:], ids[5:])}
    df, reports = ssim.curate_dataset(classes, output_csv=tmp_path / "port.csv", device="cpu")
    jdf, jreports = jax_ssim.curate_dataset(classes, output_csv=tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert df.equals(jdf) and sorted(df[df["class"] == "benign"]["id"]) == [3, 4, 20, 21, 22]
    assert {c: r.groups for c, r in reports.items()} == {c: r.groups for c, r in jreports.items()}


def test_the_cli_curates_a_raw_tree_and_needs_a_gpu_unless_told(tmp_path, monkeypatch):
    """``main`` over a raw BUSI tree (images only; masks are skipped) writes
    the JAX CLI's CSV; without a GPU it raises unless asked for the CPU."""
    import cv2

    from multi_task_breast_cancer_tpu_torch.data.synthetic import make_raw_busi

    raw = make_raw_busi(tmp_path / "raw", n_per_class=3, size=40, seed=2)
    benign = raw / "benign"
    cv2.imwrite(str(benign / "benign (4).png"), cv2.imread(str(benign / "benign (2).png"), 0))
    out = tmp_path / "curated.csv"
    argv = ["--input", str(raw), "--output", str(out), "--size", "32"]
    ssim.main(argv + ["--device", "cpu"])
    monkeypatch.setattr("sys.argv",
                        ["ssim"] + argv[:3] + [str(tmp_path / "jax.csv"), "--size", "32"])
    jax_ssim.main()
    assert out.read_bytes() == (tmp_path / "jax.csv").read_bytes()
    assert "benign;4" not in out.read_text() and "benign;2" in out.read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssim.main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ssim.ssim_pairwise(_images()[0], np.array([[0, 1]]))
