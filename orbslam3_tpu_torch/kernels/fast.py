"""Dense FAST-9/16 corner detection + spatially uniform top-K selection.

Port of `orbslam3_tpu/kernels/fast.py`. The circle neighbours wrap around
the image edges (`torch.roll`, like the reference's `jnp.roll`); the border
is zeroed afterwards. Ties are broken by lowest index, as `jax.lax.top_k`
and the reference's stable `argsort` break them: per-cell top-K is a stable
descending sort, never `torch.topk`, whose order among equal values is not
specified. Level-0 FAST scores are sums of integer differences and the
rank-major keys are coarse f32 numbers, so ties are common.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, circular order (dy, dx) — standard FAST-16.
CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LEN = 9  # FAST-9
BORDER = 3

INI_TH = 20.0  # reference iniThFAST (EuRoC.yaml ORBextractor.iniThFAST)
MIN_TH = 7.0   # reference minThFAST
STRONG_BONUS = 1e6  # rank strong-threshold corners above all weak ones


def _circle_neighbors(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) stack of the circle-neighbour values of every pixel."""
    return torch.stack([torch.roll(img, (-dy, -dx), dims=(0, 1))
                        for dy, dx in CIRCLE])


def _contiguous_arc(mask16: torch.Tensor) -> torch.Tensor:
    """True where >= ARC_LEN contiguous bits are set in the circular 16-bit
    mask: (16, H, W) bool -> (H, W) bool.

    Same bit trick as the reference, in int64 so that the 32-bit doubled
    word never meets a sign bit under `>>`.
    """
    weights = (1 << torch.arange(16, dtype=torch.int64,
                                 device=mask16.device))[:, None, None]
    packed = torch.sum(torch.where(mask16, weights, 0), dim=0)
    m2 = packed | (packed << 16)
    r = m2
    for k in range(1, ARC_LEN):
        r = r & (m2 >> k)
    return (r & 0xFFFF) != 0


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """(H, W) corner response; 0 where not a corner."""
    diff = _circle_neighbors(img) - img[None]
    is_corner = _contiguous_arc(diff > threshold) | _contiguous_arc(diff < -threshold)
    score_b = torch.sum(torch.clamp(diff - threshold, min=0.0), dim=0)
    score_d = torch.sum(torch.clamp(-diff - threshold, min=0.0), dim=0)
    score = torch.maximum(score_b, score_d)
    h, w = img.shape
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[BORDER:h - BORDER, BORDER:w - BORDER] = True
    return torch.where(is_corner & interior, score, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression (keep local maxima; padding is -inf)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= mx, score, 0.0)


def detect(img: torch.Tensor, ini_th: float = INI_TH, min_th: float = MIN_TH) -> torch.Tensor:
    """Dual-threshold dense FAST + NMS -> response map (`detect_with_raw`'s
    first result)."""
    return detect_with_raw(img, ini_th, min_th)[0]


def detect_with_raw(img: torch.Tensor, ini_th: float = INI_TH,
                    min_th: float = MIN_TH):
    """Dual-threshold dense FAST + NMS, plus the pre-NMS/pre-bonus response
    used for the sub-pixel fit. High-threshold corners get STRONG_BONUS."""
    weak = fast_score_map(img, min_th)
    strong_mask = fast_score_map(img, ini_th) > 0
    score = weak + torch.where(strong_mask & (weak > 0), STRONG_BONUS, 0.0)
    return nms3(score), weak


def subpixel_offsets(raw_score: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor):
    """Sub-pixel peak offsets (dy, dx) in [-0.5, 0.5] by separable 3x3
    quadratic interpolation; zero where the fit is degenerate."""
    h, w = raw_score.shape
    flat = raw_score.reshape(-1)

    def grab(dy, dx):
        yy = torch.clamp(ys + dy, 0, h - 1)
        xx = torch.clamp(xs + dx, 0, w - 1)
        return flat[yy * w + xx]

    c = grab(0, 0)

    def fit(lo, hi):
        denom = lo - 2.0 * c + hi
        usable = torch.abs(denom) > 1e-6
        off = torch.where(usable, 0.5 * (lo - hi) / torch.where(usable, denom, 1.0),
                          0.0)
        off = torch.where(denom < 0, off, 0.0)  # only interior maxima
        return torch.clamp(off, -0.5, 0.5)

    return fit(grab(-1, 0), grab(1, 0)), fit(grab(0, -1), grab(0, 1))


def select_uniform(score: torch.Tensor, num: int, cell: int = 32,
                   per_cell: int = 4):
    """Spatially uniform top-`num` selection from a response map.

    Returns (ys, xs, resp, valid), each (num,): every cell's top-`per_cell`
    corners, in rank-major order (every cell's best first, by response,
    then every cell's second, ...).
    """
    h, w = score.shape
    ph = -(-h // cell) * cell
    pw = -(-w // cell) * cell
    s = F.pad(score, (0, pw - w, 0, ph - h))
    cy, cx = ph // cell, pw // cell
    cells = s.reshape(cy, cell, cx, cell).permute(0, 2, 1, 3).reshape(
        cy * cx, cell * cell)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    top_val, top_idx = vals[:, :per_cell], idx[:, :per_cell]
    ci = torch.arange(cy * cx, device=score.device)
    yy = ((ci // cx) * cell)[:, None] + top_idx // cell
    xx = ((ci % cx) * cell)[:, None] + top_idx % cell
    # key: lower is better; rank * 1e9 - response lets the rank dominate
    valid = top_val > 0
    rank = torch.arange(per_cell, dtype=torch.float32, device=score.device)
    key = torch.where(valid, rank[None, :] * 1e9 - top_val, torch.inf)
    flat_key = key.reshape(-1)
    order = torch.sort(flat_key, stable=True).indices[:num]
    sel_y = yy.reshape(-1)[order]
    sel_x = xx.reshape(-1)[order]
    sel_v = top_val.reshape(-1)[order]
    sel_valid = torch.isfinite(flat_key[order])
    resp = torch.where(sel_v > STRONG_BONUS / 2, sel_v - STRONG_BONUS, sel_v)
    return sel_y, sel_x, resp, sel_valid
