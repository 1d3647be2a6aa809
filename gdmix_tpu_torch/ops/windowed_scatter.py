"""Windowed scatter-add over a pre-sorted entry stream: the cold side of the
wide-D hybrid.

Port of gdmix_tpu/ops/pallas/windowed_scatter.py
(`windowed_scatter_add_pallas`), on the same layout, so the two can be held
against each other on identical inputs. On a CUDA tensor
`windowed_scatter_add` launches the hand-written kernel of
csrc/windowed_scatter.cu, which walks a work plan built once per layout
(`windowed_plan`); on a CPU tensor it takes the plain PyTorch version beside
it (the window offset expanded per entry, then one `index_add_`). The
wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN

KPACK = 16          # entries per packed row of the layout
# the plan's items: int32 rows of ITEM_INTS (kItemInts in
# csrc/windowed_scatter.cu): its tiles [begin, end), its window, part (−1:
# the item owns its window; else its scratch row), the window's first
# scratch row, its number of items, its counter
ITEM_INTS = 7


class WindowedPlan(NamedTuple):
    """The kernel's work items for one layout, built once (windowed_plan).

    items [n_items, ITEM_INTS] int32, the largest first (the kernel's
    blocks take them in that order from a queue); scratch [parts, window]
    float32, a row for each item of a split window; counters [2 + split
    windows] int32 (the queue's two, then one a split window), zero between
    calls (the kernel sets each back). A plan serves one stream at a
    time."""
    items: torch.Tensor
    scratch: torch.Tensor
    counters: torch.Tensor
    tile_cap: int           # T: the most tiles an item reads
    tiles_read: int         # the tiles the items read, all told


def windowed_plan(win_of_tile: torch.Tensor, values: torch.Tensor,
                  num_windows: int, window: int, *,
                  blocks: int = 0) -> WindowedPlan:
    """The work plan of a layout: win_of_tile [n_tiles] (non-decreasing)
    and the layout's values [n_tiles·tile_rows, 16]; a tile whose values
    are all 0 contributes 0 in every call and is left out. An item reads a
    run of consecutive tiles of one window, at most T of them, T = ⌈tiles
    read / blocks⌉ (`blocks`, on a card by default the kernel's persistent
    grid there: one wave); a window whose tiles to read are more than T,
    or not consecutive, is split into items of near-equal size, and a
    window with none has one item of no tile. Items are listed largest
    first. One host read of a flag per tile."""
    n_tiles = win_of_tile.shape[0]
    dev = win_of_tile.device
    if blocks <= 0:
        if dev.type != "cuda":
            raise ValueError("windowed_plan: off a card, give `blocks`")
        blocks = _grid(_library(), window, dev)
    live = (values.reshape(n_tiles, -1) != 0).any(1).cpu().numpy()
    win = win_of_tile.cpu().numpy().astype(np.int64)
    cap = max(1, -(-int(live.sum()) // blocks))
    # the runs of tiles to read: consecutive, live, of one window; a run
    # ends at the next tile that is not live or starts a window
    new_win = np.append(True, win[1:] != win[:-1])
    starts = np.nonzero(live & (new_win | ~np.append(False, live[:-1])))[0]
    breaks = np.append(np.nonzero(~live | new_win)[0], n_tiles)
    ends = breaks[np.searchsorted(breaks, starts, side="right")]
    pieces = [[] for _ in range(num_windows)]
    for s, e in zip(starts, ends):
        n = int(e - s)
        k = -(-n // cap)
        cuts = s + (np.arange(k + 1) * n) // k
        pieces[win[s]] += list(zip(cuts[:-1], cuts[1:]))
    first_tile = np.searchsorted(win, np.arange(num_windows))
    items, part, counter = [], 0, 0
    for w, ps in enumerate(pieces):
        if not ps:
            ps = [(first_tile[w], first_tile[w])]
        if len(ps) == 1:
            items.append((ps[0][0], ps[0][1], w, -1, 0, 1, 0))
            continue
        items += [(a, b, w, part + i, part, len(ps), counter)
                  for i, (a, b) in enumerate(ps)]
        part += len(ps)
        counter += 1
    items = np.asarray(items, np.int64).reshape(-1, ITEM_INTS)
    items = items[np.argsort(items[:, 0] - items[:, 1], kind="stable")]
    return WindowedPlan(
        items=torch.as_tensor(items.astype(np.int32), device=dev),
        scratch=torch.empty(part, window, dtype=torch.float32, device=dev),
        counters=torch.zeros(2 + counter, dtype=torch.int32, device=dev),
        tile_cap=cap, tiles_read=int((items[:, 1] - items[:, 0]).sum()))


def _check_layout(idx_local, contrib, win_of_tile, window, tile_rows):
    rows = idx_local.shape[0]
    if (idx_local.dim() != 2 or idx_local.shape[1] != KPACK
            or tuple(contrib.shape) != tuple(idx_local.shape)
            or tile_rows <= 0 or rows % tile_rows or window <= 0
            or tuple(win_of_tile.shape) != (rows // tile_rows,)):
        raise ValueError(
            f"windowed_scatter_add: idx_local {tuple(idx_local.shape)} and "
            f"contrib {tuple(contrib.shape)} must be [M/16, 16] in tiles of "
            f"{tile_rows} rows, win_of_tile {tuple(win_of_tile.shape)} one "
            f"window id per tile, window {window} > 0")


def windowed_scatter_add_plain(idx_local, contrib, win_of_tile,
                               num_windows: int, window: int,
                               tile_rows: int) -> torch.Tensor:
    """The plain version: every entry's target expanded, one `index_add_`."""
    _check_layout(idx_local, contrib, win_of_tile, window, tile_rows)
    tile_e = tile_rows * KPACK
    win, idx = win_of_tile.long(), idx_local.reshape(-1, tile_e).long()
    val = contrib.reshape(-1, tile_e).to(torch.float32)
    target = win[:, None] * window + idx
    return torch.zeros(num_windows * window, dtype=torch.float32,
                       device=contrib.device).index_add_(
        0, target.reshape(-1), val.reshape(-1))


def _library():
    """The library, its entry point typed once, at its first use."""
    lib = _cuda.load("windowed_scatter")
    if not getattr(lib, "_gdx_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.gdx_windowed_scatter_add.argtypes = (
            [P, P, I, I, P, I, P, P, I, P, P])
        lib.gdx_windowed_scatter_add.restype = I
        lib.gdx_windowed_scatter_setup.argtypes = [I, P]
        lib.gdx_windowed_scatter_setup.restype = I
        lib.gdx_windowed_scatter_ring_bytes.restype = I
        # the kernel's shared memory besides the window: its ring of chunks
        lib._gdx_ring = lib.gdx_windowed_scatter_ring_bytes()
        lib._gdx_grid = {}
        lib._gdx_typed = True
    return lib


def _grid(lib, window: int, device: torch.device) -> int:
    """The persistent grid (SMs × resident blocks) for windows of this
    size on this card; the kernel's shared memory is set here, once per
    (window, card)."""
    key = (window, device)
    grid = lib._gdx_grid.get(key)
    if grid is None:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            _cuda.check(lib, lib.gdx_windowed_scatter_setup(
                window, ctypes.byref(per_sm)), "windowed_scatter_add setup")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        grid = lib._gdx_grid[key] = sms * max(per_sm.value, 1)
    return grid


def windowed_scatter_add(idx_local: torch.Tensor, contrib: torch.Tensor,
                         win_of_tile: torch.Tensor, num_windows: int,
                         window: int, tile_rows: int,
                         plan: WindowedPlan = None) -> torch.Tensor:
    """Σ-scatter `contrib` at window-LOCAL positions `idx_local` into a
    float32 table of num_windows·window slots.

    idx_local [M/16, 16] int32 and contrib [M/16, 16] float32 hold the
    entries 16 to a row in tile order; win_of_tile [n_tiles] int32 is the
    NON-DECREASING window of each tile of `tile_rows` rows, every window
    covered by at least one tile; padding carries contribution 0. On a card
    `plan` (windowed_plan of this layout) is required: the kernel writes
    every window from it, so the table is not cleared first. The CPU route
    needs no plan and reads none."""
    if contrib.device.type == "cpu":
        return windowed_scatter_add_plain(idx_local, contrib, win_of_tile,
                                          num_windows, window, tile_rows)
    what = "windowed_scatter_add"
    _cuda.require_cuda(what, idx_local, win_of_tile, dtypes=(torch.int32,))
    _cuda.require_cuda(what, contrib, dtypes=(torch.float32,))
    if len({t.device for t in (idx_local, contrib, win_of_tile)}) != 1:
        raise ValueError(f"{what}: tensors on more than one device")
    _check_layout(idx_local, contrib, win_of_tile, window, tile_rows)
    if plan is None:
        raise ValueError(f"{what}: a card needs the layout's plan "
                         "(windowed_plan)")
    lib = _library()
    if 4 * window + lib._gdx_ring > SMEM_OPTIN or window % 4:
        raise ValueError(f"{what}: a window of {window} floats must be a "
                         "multiple of 4 that fits a block's shared memory")
    if idx_local.data_ptr() % 16 or contrib.data_ptr() % 16:
        raise ValueError(f"{what}: idx_local and contrib must be 16-byte "
                         "aligned")
    if (plan.scratch.shape[1:] != (window,)
            or plan.items.device != contrib.device
            or plan.tile_cap * tile_rows * KPACK >= 2 ** 31):
        raise ValueError(f"{what}: the plan is not for windows of {window} "
                         f"and tiles of {tile_rows} rows on "
                         f"{contrib.device}")
    dev = contrib.device
    out = torch.empty(num_windows * window, dtype=torch.float32, device=dev)
    with _cuda.on_card(out) as stream:
        err = lib.gdx_windowed_scatter_add(
            _cuda.ptr(idx_local), _cuda.ptr(contrib), tile_rows * KPACK,
            window, _cuda.ptr(plan.items), plan.items.shape[0],
            _cuda.ptr(plan.scratch), _cuda.ptr(plan.counters),
            _grid(lib, window, dev), _cuda.ptr(out), stream)
    _cuda.check(lib, err, what)
    windowed_scatter_add.launches += 1
    return out


windowed_scatter_add.launches = 0
