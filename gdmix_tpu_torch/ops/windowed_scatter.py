"""Windowed scatter-add over a pre-sorted entry stream: the cold side of the
wide-D hybrid.

Port of gdmix_tpu/ops/pallas/windowed_scatter.py
(`windowed_scatter_add_pallas`), on the same layout, so the two can be held
against each other on identical inputs. On a CUDA tensor
`windowed_scatter_add` launches the hand-written kernel of
csrc/windowed_scatter.cu; on a CPU tensor it takes the plain PyTorch version
beside it (the window offset expanded per entry, then one `index_add_`).
The wrapper counts its launches in `.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from gdmix_tpu_torch.ops import _cuda
from gdmix_tpu_torch.ops.linsolve import SMEM_OPTIN

KPACK = 16          # entries per packed row of the layout


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
    _check_layout(idx_local, contrib, win_of_tile, window, tile_rows)
    win = win_of_tile.long().repeat_interleave(tile_rows * KPACK)
    target = win * window + idx_local.reshape(-1).long()
    return torch.zeros(num_windows * window, dtype=torch.float32,
                       device=contrib.device).index_add_(
        0, target, contrib.reshape(-1).to(torch.float32))


def _tiles_per_block(n_tiles: int, device: torch.device) -> int:
    """Runs of tiles per block: about one wave of eight 256-thread blocks
    per SM (a block's 16 KB window leaves room for eight), so a window's
    flush is shared by several tiles where windows are long."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, -(-n_tiles // (8 * sms)))


def windowed_scatter_add(idx_local: torch.Tensor, contrib: torch.Tensor,
                         win_of_tile: torch.Tensor, num_windows: int,
                         window: int, tile_rows: int) -> torch.Tensor:
    """Σ-scatter `contrib` at window-LOCAL positions `idx_local` into a
    float32 table of num_windows·window slots.

    idx_local [M/16, 16] int32 and contrib [M/16, 16] float32 hold the
    entries 16 to a row in tile order; win_of_tile [n_tiles] int32 is the
    NON-DECREASING window of each tile of `tile_rows` rows, every window
    covered by at least one tile; padding carries contribution 0."""
    if contrib.device.type == "cpu":
        return windowed_scatter_add_plain(idx_local, contrib, win_of_tile,
                                          num_windows, window, tile_rows)
    what = "windowed_scatter_add"
    _cuda.require_cuda(what, idx_local, win_of_tile, dtypes=(torch.int32,))
    _cuda.require_cuda(what, contrib, dtypes=(torch.float32,))
    if len({t.device for t in (idx_local, contrib, win_of_tile)}) != 1:
        raise ValueError(f"{what}: tensors on more than one device")
    _check_layout(idx_local, contrib, win_of_tile, window, tile_rows)
    if 4 * window > SMEM_OPTIN:
        raise ValueError(f"{what}: a window of {window} floats does not fit "
                         "a block's shared memory")
    n_tiles = win_of_tile.shape[0]
    out = torch.zeros(num_windows * window, dtype=torch.float32,
                      device=contrib.device)
    lib = _cuda.load("windowed_scatter")
    fn = lib.gdx_windowed_scatter_add
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(contrib.device):
        err = fn(_cuda.ptr(idx_local), _cuda.ptr(contrib),
                 _cuda.ptr(win_of_tile), n_tiles, tile_rows * KPACK,
                 num_windows, window, _tiles_per_block(n_tiles,
                                                       contrib.device),
                 _cuda.ptr(out), _cuda.stream_of(contrib))
    _cuda.check(lib, err, what)
    windowed_scatter_add.launches += 1
    return out


windowed_scatter_add.launches = 0
