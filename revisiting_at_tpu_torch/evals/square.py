"""Square attack (Andriushchenko et al. 2020), Linf/L2/L1, port of
revisiting_at_tpu/evals/square.py.

The fourth attack of standard AutoAttack (5000 queries, p_init=0.8,
margin-loss acceptance). The state per sample is (x_best, margin_min,
loss_min). As in the JAX package, the official dynamic square size s(it)
is served by evaluating the "eta" pyramid pattern analytically on index
grids (`_eta_value`), and the official `idx_to_fool` filtering by querying
every row on every step and freezing the rows already misclassified under
a mask: the same trajectories, with fixed shapes.

Draws are injectable. Every random number comes from a `SquareDraws`
object, keyed on the absolute query index: the Linf init stripes, the
L2/L1 init grid's coins and signs, and per query Linf's per-sample window
corners and signs for that query's window size, or L2/L1's four window
coordinates, signs and transpose coin. So a test can replay the JAX
package's threefry draws. `TorchSquareDraws` draws from a torch.Generator
seeded from (seed, query).

Deviations from the official library, both the JAX package's:
- Linf: the official per-image "resample the window until the candidate
  differs" loop (square.py Linf branch) is left out; it only avoids
  wasted queries and never changes an accepted iterate (ROADMAP C5).
- Acceptance is a strict improvement of the margin loss with broken rows
  frozen, the official update applied to `idx_to_fool`.
"""

from __future__ import annotations

from typing import Callable, Protocol

import numpy as np
import torch

from ..ops.norms import l1_projection

LogitsFn = Callable[[torch.Tensor], torch.Tensor]
Carry = tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_MILESTONES = (10, 50, 200, 500, 1000, 2000, 4000, 6000, 8000)
_DIVISORS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0, 512.0)


class SquareDraws(Protocol):
    """The random numbers of one Square run, on the attack's device.
    Signs are f32 +1 or -1."""

    def linf_init(self, b: int, w: int, c: int) -> torch.Tensor:
        """Signs of the Linf init's vertical stripes, [b, 1, w, c]."""

    def linf_query(self, it: int, b: int, c: int, h: int, w: int, s: int):
        """(vh [b] in [0, h - s], vw [b] in [0, w - s], signs [b, 1, 1, c]) of Linf query it."""

    def grid_init(self, b: int, c: int, n_tiles: int):
        """(coins bool [n_tiles], signs [n_tiles, b, 1, 1, c]) of the L2/L1 init grid."""

    def lp_query(self, it: int, b: int, c: int):
        """(u f32 [4] in [0, 1), signs [b, 1, 1, c], transpose bool []) of L2/L1 query it."""


class TorchSquareDraws:
    """SquareDraws from a torch.Generator on `device`, seeded from (seed, query)
    (the init draws take the query index -1), returned on `out_device`
    (default `device`): drawn on the CPU and returned on the card, a run on
    the card takes the draws of a run on the CPU."""

    def __init__(self, seed: int, device, out_device=None):
        self.seed, self.device = seed, torch.device(device)
        self.out_device = torch.device(out_device) if out_device is not None else self.device

    def _gen(self, it: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + it + 1) % (2 ** 63 - 1))
        return gen

    def _out(self, *ts):
        out = tuple(t.to(self.out_device) for t in ts)
        return out if len(out) > 1 else out[0]

    def _signs(self, shape, gen) -> torch.Tensor:
        return torch.where(torch.rand(shape, generator=gen, device=self.device) < 0.5, 1.0, -1.0)

    def linf_init(self, b, w, c):
        return self._out(self._signs((b, 1, w, c), self._gen(-1)))

    def linf_query(self, it, b, c, h, w, s):
        gen = self._gen(it)
        vh = torch.randint(0, h - s + 1, (b,), generator=gen, device=self.device)
        vw = torch.randint(0, w - s + 1, (b,), generator=gen, device=self.device)
        return self._out(vh, vw, self._signs((b, 1, 1, c), gen))

    def grid_init(self, b, c, n_tiles):
        gen = self._gen(-1)
        coins = torch.rand(n_tiles, generator=gen, device=self.device) < 0.5
        return self._out(coins, self._signs((n_tiles, b, 1, 1, c), gen))

    def lp_query(self, it, b, c):
        gen = self._gen(it)
        u = torch.rand(4, generator=gen, device=self.device)
        signs = self._signs((b, 1, 1, c), gen)
        return self._out(u, signs, torch.rand((), generator=gen, device=self.device) < 0.5)


def _margin_loss(logits: torch.Tensor, y: torch.Tensor):
    """(margin, loss) with margin = z_y - max_{k != y} z_k and loss = margin
    (the official 'margin' criterion of AutoAttack's Square)."""
    z = logits.float()
    zy = z.gather(1, y[:, None])[:, 0]
    other = torch.zeros_like(z, dtype=torch.bool).scatter_(1, y[:, None], True)
    margin = zy - z.masked_fill(other, -torch.inf).amax(-1)
    return margin, margin


def _p_selection(p_init: float, it: int) -> np.float32:
    """The official square-size schedule on raw query milestones
    (resc_schedule=False), in f32 as the JAX package computes it."""
    idx = sum(it > m for m in _MILESTONES)
    return np.float32(p_init) / np.float32(_DIVISORS[idx])


# The official "eta" pattern, evaluated analytically: eta_rectangles(x, y)
# adds 1/(k+1)^2 over growing (2k+1)-squares anchored at (x_c - 1, y_c - 1),
# x_c = x // 2 + 1, so cell (i, j) holds the tail sum of 1/(k+1)^2 from
# k0 = max(x_c-1-i, i-x_c+1, y_c-1-j, j-y_c+1, 0) to max(x_c, y_c) - 1.
# eta(s) stacks [rect(s//2, s); -rect(s - s//2, s)], normalizes, and is
# transposed on a coin.


def _tail_table(n: int, device) -> torch.Tensor:
    """tail[k] = sum_{m=k}^{n-1} 1/(m+1)^2, length n + 1 (tail[n] = 0)."""
    inv = 1.0 / (np.arange(1, n + 1, dtype=np.float64) ** 2)
    tail = np.concatenate([np.cumsum(inv[::-1])[::-1], [0.0]])
    return torch.from_numpy(tail.astype(np.float32)).to(device)


def _rect_value(i, j, x: int, y: int, tail) -> torch.Tensor:
    """eta_rectangles(x, y) at integer grids i, j (zero outside [0, x) x [0, y)),
    not normalized."""
    x_c, y_c = x // 2 + 1, y // 2 + 1
    k0 = torch.maximum(torch.maximum(x_c - 1 - i, i - x_c + 1),
                       torch.maximum(y_c - 1 - j, j - y_c + 1)).clamp(min=0)
    last = tail.shape[0] - 1
    val = tail[k0.clamp(max=last)] - tail[min(max(x_c, y_c), last)]
    inside = (i >= 0) & (i < x) & (j >= 0) & (j < y)
    return torch.where(inside, val.clamp(min=0.0), 0.0)


def _eta_value(di, dj, s: int, tail, transpose) -> torch.Tensor:
    """The official eta(s) at offsets (di, dj) from the window's corner, of
    unit L2 norm over its support; `transpose` (a bool tensor) swaps the offsets."""
    di, dj = torch.where(transpose, dj, di), torch.where(transpose, di, dj)
    top = _rect_value(di, dj, s // 2, s, tail)
    top = top / torch.sqrt((top ** 2).sum() + 1e-30)
    bot = _rect_value(di - s // 2, dj, s - s // 2, s, tail)
    bot = bot / torch.sqrt((bot ** 2).sum() + 1e-30)
    e = top - bot
    return e / torch.sqrt((e ** 2).sum() + 1e-30)


def _rand_int(u: torch.Tensor, high: int) -> torch.Tensor:
    """The official random_int(0, high): floor(u * high), never high itself."""
    return torch.floor(u * high).long()


def _grids(h: int, w: int, device):
    """Row and column indices, each [1, h, w, 1]."""
    ys = torch.arange(h, device=device).view(1, h, 1, 1).expand(1, h, w, 1)
    xs = torch.arange(w, device=device).view(1, 1, w, 1).expand(1, h, w, 1)
    return ys, xs


def _window(ys, xs, vh, vw, s: int) -> torch.Tensor:
    return (ys >= vh) & (ys < vh + s) & (xs >= vw) & (xs < vw + s)


def _grid_init(x: torch.Tensor, draws: SquareDraws, tail) -> torch.Tensor:
    """The official L2/L1 init: the image tiled with eta(h // 5) patterns
    times per-(sample, channel) signs, not normalized."""
    b, h, w, c = x.shape
    s0 = max(h // 5, 2)  # official: h // 5 (guarded for tiny test images)
    n_h, n_w = h // s0, w // s0
    sp_h, sp_w = (h - n_h * s0) // 2, (w - n_w * s0) // 2
    coins, signs = draws.grid_init(b, c, n_h * n_w)
    ys, xs = _grids(h, w, x.device)
    delta = torch.zeros_like(x)
    t = 0
    for ih in range(n_h):
        for iw in range(n_w):
            pat = _eta_value(ys - (sp_h + ih * s0), xs - (sp_w + iw * s0), s0, tail, coins[t])
            delta = delta + pat * signs[t]
            t += 1
    return delta


def _accept(carry: Carry, cand, margin_c, loss_c) -> Carry:
    """Take strictly improving candidates; rows already broken stay frozen."""
    x_best, margin_min, loss_min = carry
    take = (loss_c < loss_min) & (margin_min > 0.0)
    return (torch.where(take[:, None, None, None], cand, x_best),
            torch.where(take, margin_c, margin_min), torch.where(take, loss_c, loss_min))


def _lp_parts(logits_fn: LogitsFn, x, y, eps: float, p_init: float, draws: SquareDraws,
              norm: str):
    """The official L2 and L1 Square attacks (autoattack square.py). One
    window pair per query, shared by the batch: window 2's mass is freed,
    window 1 is overwritten with (eta * signs + its old content of unit
    norm) scaled to the per-channel budget, and the perturbation goes back
    onto the eps sphere (L2: rescaled; L1: projected exactly onto the L1
    ball and the box by ops/norms.l1_projection). Returns (init, body):
    init() -> carry, body(carry, it) -> carry, `it` the absolute query index."""
    b, h, w, c = x.shape
    n_features = h * w * c
    tail = _tail_table(h + 2, x.device)
    ys, xs = _grids(h, w, x.device)
    if norm == "L2":
        def nrm(t, dims):
            return torch.sqrt((t ** 2).sum(dims, keepdim=True))
    else:
        def nrm(t, dims):
            return t.abs().sum(dims, keepdim=True)

    def init() -> Carry:
        delta = _grid_init(x, draws, tail)
        if norm == "L2":
            x_best = torch.clamp(x + delta / (nrm(delta, (1, 2, 3)) + 1e-12) * eps, 0.0, 1.0)
        else:
            delta = delta / (nrm(delta, (1, 2, 3)) + 1e-12) * eps
            delta = delta + l1_projection(x, delta, eps)
            x_best = torch.clamp(x + delta, 0.0, 1.0)
        margin, loss = _margin_loss(logits_fn(x_best), y)
        return x_best, margin, loss

    def body(carry: Carry, it: int) -> Carry:
        x_best = carry[0]
        u, signs, transpose = draws.lp_query(it, b, c)
        p = _p_selection(p_init, it)
        s = max(int(np.round(np.sqrt(p * np.float32(n_features) / np.float32(c)))), 3)
        s = min(s + (1 - s % 2), h - 1)  # official: odd s
        vh, vw = _rand_int(u[0], h - s), _rand_int(u[1], w - s)
        vh2, vw2 = _rand_int(u[2], h - s), _rand_int(u[3], w - s)
        w1 = _window(ys, xs, vh, vw, s)
        w2 = _window(ys, xs, vh2, vw2, s)

        delta = x_best - x
        in_w1 = torch.where(w1, delta, 0.0)
        norms_window_1 = nrm(in_w1, (1, 2))
        norms_image = nrm(delta, (1, 2, 3))
        norms_windows = nrm(torch.where(w1 | w2, delta, 0.0), (1, 2))

        new_deltas = _eta_value(ys - vh, xs - vw, s, tail, transpose) * signs
        new_deltas = new_deltas + in_w1 / (1e-12 + norms_window_1)
        new_norm = nrm(torch.where(w1, new_deltas, 0.0), (1, 2))
        if norm == "L2":
            budget = torch.sqrt(torch.clamp(eps ** 2 - norms_image ** 2, min=0.0) / c
                                + norms_windows ** 2)
        else:
            budget = torch.clamp(eps - norms_image, min=0.0) / c + norms_windows
        new_deltas = new_deltas / (1e-12 + new_norm) * budget

        cand_delta = torch.where(w1, new_deltas, torch.where(w2, 0.0, delta))
        if norm == "L2":
            cand_nrm = nrm(cand_delta, (1, 2, 3))
            cand = torch.clamp(x + cand_delta / (cand_nrm + 1e-12) * eps, 0.0, 1.0)
        else:
            cand_delta = cand_delta + l1_projection(x, cand_delta, eps)
            cand = torch.clamp(x + cand_delta, 0.0, 1.0)
        return _accept(carry, cand, *_margin_loss(logits_fn(cand), y))

    return init, body


def _linf_parts(logits_fn: LogitsFn, x, y, eps: float, p_init: float, draws: SquareDraws):
    """The official Linf Square attack: an init of +-eps vertical stripes,
    then per query and per sample a window that jumps to a random +-eps
    vertex around x. Same (init, body) contract as _lp_parts."""
    b, h, w, c = x.shape
    ys, xs = _grids(h, w, x.device)

    def init() -> Carry:
        x_best = torch.clamp(x + draws.linf_init(b, w, c) * eps, 0.0, 1.0)
        margin, loss = _margin_loss(logits_fn(x_best), y)
        return x_best, margin, loss

    def body(carry: Carry, it: int) -> Carry:
        p = _p_selection(p_init, it)
        s = min(max(int(np.round(np.sqrt(p * np.float32(h) * np.float32(w)))), 1), h - 1)
        vh, vw, signs = draws.linf_query(it, b, c, h, w, s)
        window = _window(ys, xs, vh.view(b, 1, 1, 1), vw.view(b, 1, 1, 1), s)
        cand = torch.where(window, torch.clamp(x + signs * eps, 0.0, 1.0), carry[0])
        cand = torch.clamp(torch.minimum(torch.maximum(cand, x - eps), x + eps), 0.0, 1.0)
        return _accept(carry, cand, *_margin_loss(logits_fn(cand), y))

    return init, body


def _parts(logits_fn, x, y, norm, eps, p_init, draws):
    x = x.float()
    if norm == "Linf":
        return _linf_parts(logits_fn, x, y, eps, p_init, draws)
    if norm in ("L2", "L1"):
        return _lp_parts(logits_fn, x, y, eps, p_init, draws, norm)
    raise NotImplementedError(f"square_attack: unsupported norm {norm!r}")


# The resumable API: a carry advanced over ranges of absolute query
# indices; the draws are keyed on the index.


@torch.no_grad()
def square_attack_init(logits_fn: LogitsFn, x, y, *, norm: str = "Linf",
                       eps: float = 4.0 / 255.0, p_init: float = 0.8,
                       draws: SquareDraws) -> Carry:
    """The carry (x_best, margin_min, loss_min) at the official init point,
    already scored (one query of the budget)."""
    init, _ = _parts(logits_fn, x, y, norm, eps, p_init, draws)
    return init()


@torch.no_grad()
def square_attack_chunk(logits_fn: LogitsFn, x, y, carry: Carry, it0: int, n_chunk: int, *,
                        norm: str = "Linf", eps: float = 4.0 / 255.0, p_init: float = 0.8,
                        draws: SquareDraws) -> Carry:
    """Advance the carry over the absolute query indices [it0, it0 + n_chunk).
    `draws` must be the init's."""
    _, body = _parts(logits_fn, x, y, norm, eps, p_init, draws)
    for it in range(it0, it0 + n_chunk):
        carry = body(carry, it)
    return carry


def square_attack_finish(carry: Carry):
    """(x_best, acc) from a carry; acc[i] False means misclassified."""
    x_best, margin_min, _ = carry
    return x_best, margin_min > 0.0


def square_attack(logits_fn: LogitsFn, x, y, *, norm: str = "Linf", eps: float = 4.0 / 255.0,
                  n_queries: int = 5000, p_init: float = 0.8, draws: SquareDraws):
    """The whole attack: init, then n_queries - 1 queries. Returns (x_best, acc)."""
    kw = dict(norm=norm, eps=eps, p_init=p_init, draws=draws)
    carry = square_attack_init(logits_fn, x, y, **kw)
    return square_attack_finish(
        square_attack_chunk(logits_fn, x, y, carry, 0, n_queries - 1, **kw))


def square_attack_l2(logits_fn, x, y, *, eps=2.0, n_queries=5000, p_init=0.8, draws):
    return square_attack(logits_fn, x, y, norm="L2", eps=eps, n_queries=n_queries,
                         p_init=p_init, draws=draws)


def square_attack_l1(logits_fn, x, y, *, eps=75.0, n_queries=5000, p_init=0.8, draws):
    return square_attack(logits_fn, x, y, norm="L1", eps=eps, n_queries=n_queries,
                         p_init=p_init, draws=draws)
