"""Plain reference of a served answer and the gaps by which a served answer
departs from it.

The reference answer of a multi-task model for one scan: the class
probabilities (softmax of the class logits), the lesion mask (the finest
head's logit above 0, i.e. its sigmoid above 0.5) and the class (the most
probable, or "normal" where the mask is empty: the paper's pipeline
refinement).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

CLASS_NAMES = ("benign", "malignant", "normal")
WRONG = 1e9  # the gap of an answer that no rounding explains


@torch.no_grad()
def logits(model, images: np.ndarray, device, block: int = 64):
    """Class logits (N, K) and the finest head's seg logits (N, H, W) of
    uint8 scans (N, H, W), in blocks of ``block``."""
    cls, seg = [], []
    for i in range(0, len(images), block):
        x = torch.from_numpy(images[i:i + block][:, None]).float().to(device)
        c, heads = model(x)
        cls.append(c.double().cpu())
        seg.append(heads[-1][:, 0].double().cpu())
    return torch.cat(cls).numpy(), torch.cat(seg).numpy()


def softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def answer_gaps(served: List[dict], ref_cls: np.ndarray, ref_seg: np.ndarray) -> dict:
    """Over the served answers (``probs`` (K,), ``mask`` (H, W) 0/1,
    ``predicted_class``) against the reference logits of the same scans:

    - ``answer_gap``: the largest gap of a served probability, or the margin
      by which the reference's logit of the served class lies below that of
      the class the reference answers (the served mask's refinement
      applied), whichever is larger; a class that no logit explains (not
      "normal" on an empty mask) reads ``WRONG``;
    - ``mask_gap``: the widest margin by which the reference's logit puts a
      pixel on the other side of 0 than the served mask does (0 where none).
    """
    answer_gap = mask_gap = 0.0
    for rec, c, s in zip(served, ref_cls, ref_seg):
        answer_gap = max(answer_gap,
                         float(np.abs(np.asarray(rec["probs"]) - softmax(c)).max()))
        wrong = (rec["mask"] > 0) != (s > 0)
        if wrong.any():
            mask_gap = max(mask_gap, float(np.abs(s[wrong]).max()))
        want = "normal" if not rec["mask"].any() else CLASS_NAMES[int(np.argmax(c))]
        if rec["predicted_class"] != want:
            got = CLASS_NAMES.index(rec["predicted_class"])
            answer_gap = max(answer_gap, float(c.max() - c[got]) if want != "normal"
                             else WRONG)
    return {"answer_gap": answer_gap, "mask_gap": mask_gap}


def reference_answers(ref_cls: np.ndarray, ref_seg: np.ndarray) -> List[dict]:
    """The answers the reference (or the control in its place) gives."""
    out = []
    for c, s in zip(ref_cls, ref_seg):
        mask = (s > 0).astype(np.uint8)
        cls = "normal" if not mask.any() else CLASS_NAMES[int(np.argmax(c))]
        out.append({"probs": softmax(c), "mask": mask, "predicted_class": cls})
    return out
