"""The decode kernels' launch plan in ray_tpu_torch.ops.paged_attention,
on the CPU: which kernel a call runs (`decode_takes`, mirrored by
`pdk::takes` in csrc/paged_decode.cu), how each context is split into
chunks (`decode_split`), and where the chunks' partials sit in their one
float32 buffer. These are pure functions of shapes; the kernels
themselves are held against the plain version on the card by
tests/test_torch_cuda_kernels.py.
"""

import math
import re
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import paged_attention as tpa

SRC = Path(tpa.__file__).parent / "csrc" / "paged_decode.cu"


@pytest.mark.parametrize("max_pages,page,rows,tile,max_split,want", [
    # the decode tick of the 8b engine: B 8 x KVH 8 over the 512-page
    # table; 264 blocks would take chunks of 1632 keys, so the pipelined
    # kernel's largest chunk (512) rules: 16 chunks
    (512, 16, 64, 16, 512, (512, 16)),
    # the short table: 128 keys // 5 chunks = 25 -> 16: 8 chunks, 512
    # blocks, two and more on each of 132 SMs
    (8, 16, 64, 16, 512, (16, 8)),
    # B 1: 8192 // 33 = 248 -> 240 keys, 35 chunks, 280 blocks
    (512, 16, 8, 16, 512, (240, 35)),
    # B 1 on the short table: the 16-key unit, 8 chunks (64 blocks: the
    # unit allows no more)
    (8, 16, 8, 16, 512, (16, 8)),
    # B 32: two chunks would do for the blocks; the largest chunk keeps 16
    (512, 16, 256, 16, 512, (512, 16)),
    (8, 16, 256, 16, 512, (64, 2)),
    # pages of 8 rows: the unit is the tile (lcm(8, 16) = 16)
    (512, 8, 64, 16, 512, (512, 8)),
    (8, 8, 64, 16, 512, (16, 4)),
    (8, 8, 256, 16, 512, (32, 2)),
    # pages of 64 rows: the unit is the page
    (8, 64, 64, 16, 512, (64, 8)),
    # the CUDA-core kernel: 64-key tile, chunks of at most 256 keys
    (512, 16, 64, 64, 256, (256, 32)),
    (8, 16, 64, 64, 256, (64, 2)),
    (8, 4, 64, 64, 256, (64, 1)),
])
def test_decode_split_hand_worked(max_pages, page, rows, tile, max_split,
                                  want):
    split, n = tpa.decode_split(max_pages, page, rows, tile, max_split)
    assert (split, n) == want
    assert split % page == 0 and split % tile == 0
    assert n * split >= max_pages * page > (n - 1) * split


@pytest.mark.parametrize("max_pages", [1, 8, 33, 512])
@pytest.mark.parametrize("page,tile,max_split", [
    (8, 16, 512), (16, 16, 512), (32, 16, 512), (64, 16, 512),
    (4, 64, 256), (16, 64, 256)])
@pytest.mark.parametrize("rows", [1, 64, 1024])
def test_decode_split_rules(max_pages, page, tile, max_split, rows):
    """Every split is a multiple of the page and the tile, covers the
    table, stays within the largest chunk (or the unit above it), and is
    the unit itself wherever a coarser one would give fewer than 2 x 132
    blocks."""
    split, n = tpa.decode_split(max_pages, page, rows, tile, max_split)
    unit = math.lcm(page, tile)
    ctx = max_pages * page
    assert split % unit == 0
    assert n == -(-ctx // split)
    assert split <= max(max_split, unit)
    assert split == unit or rows * n >= 2 * 132


@pytest.mark.parametrize("dtype,d,page,group,want", [
    (torch.bfloat16, 128, 16, 4, True),      # the 8b engine
    (torch.bfloat16, 64, 16, 4, True),
    (torch.bfloat16, 128, 8, 4, True),
    (torch.bfloat16, 128, 32, 4, True),
    (torch.bfloat16, 128, 64, 4, True),
    (torch.bfloat16, 64, 8, 1, True),
    (torch.bfloat16, 128, 16, 8, True),
    (torch.bfloat16, 128, 16, 3, True),
    (torch.bfloat16, 128, 16, 9, False),     # group above 8
    (torch.bfloat16, 32, 16, 4, False),      # the debug preset's head_dim
    (torch.bfloat16, 256, 16, 4, False),
    (torch.bfloat16, 128, 4, 4, False),      # 4-row pages
    (torch.float32, 128, 16, 4, False),
    (torch.float16, 128, 16, 4, False),
    (torch.float32, 64, 16, 1, False),
])
def test_decode_takes_routes_by_dtype_and_shape(dtype, d, page, group, want):
    assert tpa.decode_takes(dtype, d, page, group) is want


def test_decode_takes_mirrors_the_source():
    """`pdk::takes` in the CUDA source names the same head dims, page
    sizes and largest group as the Python constants, and the kernel's
    tile (a warp's keys a step, the split's unit) is DECODE_TILE."""
    src = SRC.read_text()
    body = re.search(r"inline bool takes\(int D, int group, int page_size\)"
                     r" \{(.*?)\}", src, re.S).group(1)
    dims = {int(x) for x in re.findall(r"D == (\d+)", body)}
    pages = {int(x) for x in re.findall(r"page_size == (\d+)", body)}
    group = int(re.search(r"group <= (\d+)", body).group(1))
    assert dims == set(tpa.DECODE_HEAD_DIMS)
    assert pages == set(tpa.DECODE_PAGE_SIZES)
    assert group == tpa.DECODE_MAX_GROUP
    tile = re.search(r"constexpr int kTile = (\d+);", src).group(1)
    assert int(tile) == tpa.DECODE_TILE


@pytest.mark.parametrize("args,want", [
    ((8, 32, 128, 1), 0),                    # one chunk: no partials
    # acc [B, H, S, D] + m and l [B, H, S]: 8 x 32 x 16 x 130 (the 8b
    # decode tick)
    ((8, 32, 128, 16), 532480),
    ((8, 32, 128, 8), 266240),
    ((3, 8, 64, 2), 3168),
])
def test_decode_partials_numel_hand_worked(args, want):
    assert tpa.decode_partials_numel(*args) == want


@pytest.mark.parametrize("b,h,d,n", [(8, 32, 128, 32), (3, 8, 64, 2),
                                     (1, 4, 64, 5)])
def test_decode_partial_offsets_carve_one_buffer(b, h, d, n):
    """acc [B, H, S, D] first, then m and l [B, H, S]: the three views
    tile the buffer exactly, and each starts 16-byte aligned."""
    m_off, l_off, acc_off = tpa.decode_partial_offsets(b, h, d, n)
    numel = tpa.decode_partials_numel(b, h, d, n)
    rows = b * h * n
    assert acc_off == 0
    assert m_off == rows * d
    assert l_off == m_off + rows
    assert l_off + rows == numel
    assert all(o * 4 % 16 == 0 for o in (acc_off, m_off))
    buf = torch.arange(numel, dtype=torch.float32)
    acc = buf[acc_off:acc_off + rows * d].view(b, h, n, d)
    m = buf[m_off:m_off + rows].view(b, h, n)
    l = buf[l_off:l_off + rows].view(b, h, n)
    seen = torch.cat([acc.flatten(), m.flatten(), l.flatten()])
    assert torch.equal(seen.sort().values, buf)


@pytest.mark.parametrize("dtype,d,page,kvh,group,b,maxp,want", [
    # the 8b engine's decode tick: pipelined kernel, 16 chunks
    (torch.bfloat16, 128, 16, 8, 4, 8, 512, (True, 512, 16)),
    # the short table of chip_smoke's narrow case
    (torch.bfloat16, 128, 16, 8, 4, 8, 8, (True, 16, 8)),
    # the debug preset (head_dim 32): CUDA-core kernel, 64-key tile
    (torch.bfloat16, 32, 16, 2, 2, 4, 8, (False, 64, 2)),
    (torch.float32, 64, 16, 2, 4, 3, 32, (False, 64, 8)),
])
def test_decode_plan(dtype, d, page, kvh, group, b, maxp, want):
    assert tpa.decode_plan(dtype, d, page, kvh, group, b, maxp) == want


def test_decode_scratch_needs_no_buffer_on_the_cpu():
    pool = torch.zeros((9, 16, 8, 128), dtype=torch.bfloat16)
    tables = torch.zeros((8, 512), dtype=torch.int32)
    assert tpa.decode_scratch(8, 32, 128, torch.bfloat16, pool,
                              tables) is None
