"""The numbers that decide `correct`: gaps between what the program produced
and what the plain reference works out from the same inputs."""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch


def rel_l2(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """‖prog − ref‖ / ‖ref‖ in float64."""
    p, r = prog.double(), ref.double().to(prog.device)
    return float(torch.linalg.vector_norm(p - r) / torch.linalg.vector_norm(r).clamp_min(1e-30))


def worst_map_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Tuple[float, str]:
    """The largest `rel_l2` over the maps both sides name, and its name."""
    gaps = [(rel_l2(prog[k], ref[k]), k) for k in ref]
    return max(gaps)


def leaf_norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Optional[Iterable[str]] = None) -> List[Tuple[float, str]]:
    """Each leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and of the
    median leaf: [(gap, leaf)], smallest first."""
    keys = list(ref if leaves is None else leaves)
    median = statistics.median(ref[k] for k in keys)
    return sorted((abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30), k) for k in keys)


def leaf_norm_gap(prog: Dict[str, float], ref: Dict[str, float],
                  leaves: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """The worst leaf of `leaf_norm_gaps`: (gap, leaf)."""
    return leaf_norm_gaps(prog, ref, leaves)[-1]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def roi_mismatch(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], tol: float) -> int:
    """ROI slots [B, R] in which the two sides differ: the mask, the label,
    or (where kept) a box value or score by more than `tol`."""
    pm, rm = prog["mask"].cpu().bool(), ref["mask"].cpu().bool()
    bad = pm != rm
    both = pm & rm
    bad |= both & (prog["labels"].cpu() != ref["labels"].cpu())
    box = (prog["boxes"].cpu().double() - ref["boxes"].cpu().double()).abs().amax(-1)
    score = (prog["scores"].cpu().double() - ref["scores"].cpu().double()).abs()
    bad |= both & ((box > tol) | (score > tol))
    return int(bad.sum())


def loss_gap(prog: List[Dict[str, float]], ref: List[Dict[str, float]], keys: Iterable[str]) -> Tuple[float, str]:
    """The worst relative gap of the loss terms `keys` over the steps."""
    gaps = []
    for i, (p, r) in enumerate(zip(prog, ref)):
        for k in keys:
            gaps.append((abs(p[k] - r[k]) / max(abs(r[k]), 1e-30), f"step {i + 1} {k}"))
    return max(gaps)
