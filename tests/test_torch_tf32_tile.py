"""The host plan of a TF32-rung launch of ``fused_complex_dot`` and
``fused_transpose_dot``: the tile :func:`tnc_tpu_torch.ops.cuda_complex.
tf32_config` picks, its shared memory, and the Python mirror of
``csrc/tf32_tile.cuh``'s constants, read from the source text. The kernel
itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 21)."""

from __future__ import annotations

import re

import pytest

from tnc_tpu_torch.ops import cuda_complex as cc

TILE_SRC = (cc.CSRC_DIR / "tf32_tile.cuh").read_text()
GEMM_SRC = (cc.CSRC_DIR / "complex_gemm.cuh").read_text()

#: the shapes phase 21 records: the random28 stem, the PEPS cell's admitted
#: transpose-dots and its K = 262144 products, the outer products (M <= 8),
#: products with a few columns, and m10's split-K pieces
SHAPES = {
    "random28 stem": (16384, 8192, 16384),
    "peps steps 0/4": (32, 64, 2048),
    "peps steps 11/15": (1024, 2048, 8192),
    "peps steps 18/19": (1024, 16384, 16384),
    "peps K=262144": (262144, 32, 32),
    "outer product": (2, 2, 2 ** 27),
    "long outer product": (64, 2, 2 ** 27),
    "tall few columns": (2 ** 20, 4000, 3),
    "one row": (64, 1, 4096),
    "few columns": (256, 4000, 3),
    "m10 piece": (2 ** 16, 1, 1),
}


def _cuh_int(name: str, src: str = TILE_SRC) -> int:
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);", src)
    assert m, name
    return int(m.group(1))


def _cuh_tiles() -> dict:
    """``using <Name> = Tile<XR, YC, BK, RD, RH>;`` of the header."""
    pat = r"using (\w+) = Tile<(\d+), (\d+), (\d+), (\d+), (\d+)>;"
    return {name: (int(xr), int(yc), int(bk), int(rd), int(rh))
            for name, xr, yc, bk, rd, rh in re.findall(pat, TILE_SRC)}


def test_mirror_constants_equal_the_header():
    tiles = _cuh_tiles()
    # no transposed wgmma tile: the outer products take the mma.sync one
    assert set(tiles) == {"Wide", "WideHigh", "FlatN"}
    assert "kSwap" not in TILE_SRC
    wide, flat_n = cc.TF32_TILES[:2]
    assert not wide.swap and not flat_n.swap
    # the wide tile: `default` on Wide, `high` on WideHigh (tf32::Wide /
    # WideHigh by rung in the launchers)
    assert tiles["Wide"][:4] == (wide.xr, wide.yc, wide.bk_default, wide.raw_default)
    assert tiles["WideHigh"][:3] == (wide.xr, wide.yc, wide.bk_high)
    assert tiles["WideHigh"][4] == wide.raw_high
    assert flat_n.bk_default == flat_n.bk_high
    assert tiles["FlatN"] == (flat_n.xr, flat_n.yc, flat_n.bk_default, flat_n.raw_default,
                              flat_n.raw_high)
    assert [t.name for t in cc.TF32_TILES] == ["wide", "flat_n", "mma_flat", "mma_wide",
                                               "mma_narrow"]
    assert [t.index for t in cc.TF32_TILES] == list(range(5))
    # the mma.sync tiles: Variant<float, GM, TM, TN, BK, stages, fold,
    # unroll, pad A, pad B>
    for tile, name in zip(cc.TF32_TILES[2:], ("FlatTc", "WideTc", "NarrowTc")):
        m = re.search(rf"using {name} = Variant<float, (\d+), (\d+), (\d+), (\d+), (\d+), "
                      r"\d+, \d+, (\d+), (\d+)>;", GEMM_SRC)
        gm, tm, tn, bk, stages, pad_m, pad_n = (int(x) for x in m.groups())
        assert (tile.bm, tile.bn) == (gm * tm, 256 // gm * tn)
        assert (tile.bk_default, tile.bk_high, tile.raw_default) == (bk, bk, stages)
        assert cc._MMA_PADS[tile.name] == (pad_m, pad_n)
    assert _cuh_int("kConsumers") + _cuh_int("kProducers") == cc.TF32_THREADS
    assert _cuh_int("kMaxSmemBytes", GEMM_SRC) == cc.MAX_SMEM_BYTES
    assert _cuh_int("kTma") == cc.COPY_TMA


def test_mirror_register_budget_keeps_the_block_pool():
    """setmaxnreg moves registers within the block's own pool: two consumer
    warpgroups at kConsumerRegs and the loading one at kProducerRegs take
    exactly the 384 x 168 the launch allocated (a request past it waits
    for ever), and the wide tile's two accumulator levels (MG * YC / 2
    floats each) fit the consumers'."""
    consumers, producers = _cuh_int("kConsumerRegs"), _cuh_int("kProducerRegs")
    assert consumers % 8 == 0 and producers % 8 == 0
    launch = _cuh_int("kLaunchRegs")
    assert launch * cc.TF32_THREADS <= 65536 < (launch + 8) * cc.TF32_THREADS
    assert (_cuh_int("kConsumers") * consumers + _cuh_int("kProducers") * producers
            == cc.TF32_THREADS * launch)
    wide = cc.TF32_TILES[0]
    assert 2 * (wide.xr // 64) * wide.yc // 2 <= consumers - 64


@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize("offset_itemsize", [0, 4, 8])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tf32_tiles_are_wgmma_tiles_and_fit_shared_memory(shape, offset_itemsize, rung):
    k, m, n = SHAPES[shape]
    for staged in (False, True):
        cfg = cc.tf32_config(k, m, n, rung, offset_itemsize, staged)
        assert 0 < cfg.smem_bytes <= cc.MAX_SMEM_BYTES
    tile = cc.TF32_TILES[cfg.variant]
    assert tile.name == cfg.name
    assert (cfg.bm, cfg.bn) == ((tile.yc, tile.xr) if tile.swap else (tile.xr, tile.yc))
    assert cfg.tiles(m, n) >= 1
    if tile.name.startswith("mma"):  # the classes that keep the mma.sync tiles
        assert k * m * n < cc.TF32_WGMMA_MIN_MACS or m <= 8 or offset_itemsize == 8
        assert tile.name == cc.mma_tile(m, n)
        return
    assert k * m * n >= cc.TF32_WGMMA_MIN_MACS and m > 8 and offset_itemsize < 8
    # wgmma: 64-row groups, N a multiple of 8 up to 256; a TMA box <= 256
    assert tile.xr % 64 == 0 and tile.xr <= 256
    assert tile.yc % 8 == 0 and tile.yc <= 256
    # 64- or 128-byte K-major rows: 16 or 32 floats a stage
    assert cfg.bk in (16, 32) and cfg.bk % 8 == 0
    assert cfg.raw >= 2  # the loads run at least a stage ahead of the conversion


def test_tf32_config_picks_the_tile_by_shape():
    assert cc.tf32_config(16384, 8192, 16384, "default")[:6] == (0, "wide", 64, 128, 32, 2)
    assert cc.tf32_config(16384, 8192, 16384, "high")[:6] == (0, "wide", 64, 128, 16, 5)
    # under 2^30 multiply-adds (batch rows included): the mma.sync tiles
    assert cc.tf32_config(2, 2, 2 ** 27, "high")[:4] == (2, "mma_flat", 8, 512)
    assert cc.tf32_config(512, 4096, 320, "default").name == "mma_wide"  # 128 x 64: 32 x 5 tiles
    assert cc.tf32_config(1024, 1024, 1023, "default").name == "mma_narrow"  # 128 tiles < 132
    assert cc.tf32_config(1024, 1024, 1024, "default").name == "wide"
    assert cc.tf32_config(1024, 1024, 256, "default", batch=4).name == "wide"
    assert cc.tf32_config(1024, 64, 2048, "high")[:4] == (4, "mma_narrow", 64, 64)
    assert cc.tf32_config(1024, 128, 2048, "high").name == "mma_narrow"  # 32 tiles < 132
    assert cc.tf32_config(2 ** 16, 1, 1, "default").name == "mma_flat"
    # 2^30 and over: the wgmma tile, but the outer products (M <= 8)
    assert cc.tf32_config(2 ** 20, 8, 2 ** 10, "default")[:4] == (2, "mma_flat", 8, 512)
    assert cc.tf32_config(2 ** 20, 9, 2 ** 10, "default").name == "wide"
    assert cc.tf32_config(2 ** 20, 4000, 3, "default")[:4] == (1, "flat_n", 256, 8)
    with pytest.raises(ValueError):
        cc.tf32_config(64, 64, 64, "float32")


@pytest.mark.parametrize("rung", ["high", "default"])
def test_tf32_shared_memory_counts_slots_levels_and_tables(rung):
    """The raw slots and two compute slots of the four operand parts (a lo
    level beside the hi one at ``high``), each part in whole 1 KB atoms, the
    barriers, the alignment slack and the transpose kernel's tables; as
    many raw slots as fit beside them, in steps of two at ``high``'s
    wider compute slots."""
    for k, m, n in ((16384, 8192, 16384), (1024, 16384, 16384), (2 ** 20, 4000, 3)):
        cfg = cc.tf32_config(k, m, n, rung)
        tile = cc.TF32_TILES[cfg.variant]
        assert not tile.name.startswith("mma")
        part = [-(-rows * cfg.bk * 4 // 1024) * 1024 for rows in (tile.xr, tile.yc)]
        slot = 2 * sum(part)
        levels = 2 if rung == "high" else 1
        assert cfg.raw == (tile.raw_high if rung == "high" else tile.raw_default)
        assert cfg.smem_bytes == 1024 + cfg.raw * slot + 2 * levels * slot + 256
        # one more raw slot would not fit, even without the tables
        assert cfg.smem_bytes + slot > cc.MAX_SMEM_BYTES
        assert cc.tf32_config(k, m, n, rung, 4).smem_bytes == (cfg.smem_bytes
                                                              + 4 * (tile.xr + tile.yc))


@pytest.mark.parametrize(("shape", "batch", "want"), [
    ("m10 piece", 8, 32),           # one mma_flat tile x batch 8: pieces of 2048
    ("random28 stem", 1, 1),        # 64 x 128 wide tiles: tiles enough
    ("peps K=262144", 1, 128),      # one mma_narrow tile: cut to pieces of 2048
    ("outer product", 1, 1),        # K = 2: nothing to cut
])
def test_split_k_pieces_reads_the_tf32_tiles(shape, batch, want):
    k, m, n = SHAPES[shape]
    tiles = cc.tf32_config(k, m, n, "high").tiles(m, n)
    assert cc.split_k_pieces(k, tiles, batch, 132) == want


def test_m10_dots_are_cut_as_before():
    """m10's K = 2^23 dots to a 1 x 1 output, batch 8: 128 pieces of 65536
    (the rule and its result unchanged by the new tiles)."""
    tiles = cc.tf32_config(2 ** 23, 1, 1, "high").tiles(1, 1)
    assert tiles == 1
    assert cc.split_k_pieces(2 ** 23, tiles, 8, 132) == 128


def test_chain_default_is_one_stage():
    """The chain depth is a compile-time constant: 0 unless a build sets
    ``TNC_TF32_CHAIN_K8``, which means the rung's own chain (one stage,
    BK / 8 k8 steps, at ``high``; kDefaultChainK8 at ``default``). The
    library's build flags set no other depth, and no launch passes one."""
    assert "#ifndef TNC_TF32_CHAIN_K8\n#define TNC_TF32_CHAIN_K8 0\n#endif" in TILE_SRC
    assert "constexpr int chain = kChainK8 > 0 ? kChainK8 : R == kTf32x3 ? KS : " \
        "kDefaultChainK8;" in TILE_SRC
    assert _cuh_int("kDefaultChainK8") == 16
    assert not any("CHAIN" in flag for flag in cc.NVCC_FLAGS)
    assert not hasattr(cc, "TF32_CHAIN_K8")


@pytest.mark.parametrize("rung", ["high", "default"])
@pytest.mark.parametrize(("k", "m", "n", "batch", "want"), [
    (2 ** 20, 8, 2 ** 10, 1, "mma_flat"),     # an outer product of 2^33: mma.sync
    (64, 2, 2 ** 27, 1, "mma_flat"),
    (2, 1, 2 ** 30, 4, "mma_flat"),
    (1024, 1024, 1024, 1, "wide"),            # 2^30: the wgmma tile
    (1024, 1024, 1023, 1, "mma_narrow"),      # just under
    (1024, 1024, 256, 4, "wide"),             # batch rows count
    (2 ** 20, 4000, 3, 1, "flat_n"),
])
def test_tf32_routing_is_the_same_at_both_rungs(k, m, n, batch, want, rung):
    """The classes that keep the mma.sync tiles (under 2^30 multiply-adds,
    M <= 8) hold at both rungs: the wgmma tile ran every other measured
    launch faster at ``default`` as at ``high``."""
    assert cc.tf32_config(k, m, n, rung, batch=batch).name == want


@pytest.mark.parametrize("rung", ["high", "default"])
def test_int64_tables_take_the_mma_tiles(rung):
    """The wgmma transpose kernel reads int32 offset tables only (one offset
    width halves its instantiations): a launch with int64 tables takes the
    mma.sync tile of its shape, whose kernels read both."""
    k, m, n = SHAPES["peps steps 18/19"]
    assert cc.tf32_config(k, m, n, rung, 4).name == "wide"
    cfg = cc.tf32_config(k, m, n, rung, 8)
    assert cfg.name == cc.mma_tile(m, n) == "mma_wide"
    assert cfg.smem_bytes == cc.tf32_config(k, m, n, rung, 4, tile="mma_wide").smem_bytes \
        + 4 * (cfg.bm + cfg.bn)


@pytest.mark.parametrize("name", [t.name for t in cc.TF32_TILES])
def test_named_tile_overrides_the_routing(name):
    """``tile=`` names the tile a launch takes (the holds of phase 21 hold a
    cut block on its whole launch's tile; ``scripts/tf32_tile_shapes.py``
    times both tiles on one launch)."""
    cfg = cc.tf32_config(2, 2, 2 ** 27, "high", tile=name)
    tile = cc.TF32_TILES[cfg.variant]
    assert (cfg.name, tile.name) == (name, name)
    assert cfg.bk == (tile.bk_high if not name.startswith("mma") else tile.bk_default)


def test_named_tile_is_checked_on_the_host():
    import torch

    x = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    want = cc.fused_complex_dot(x, x, x, x, precision="high")
    got = cc.fused_complex_dot(x, x, x, x, precision="high", tile="mma_wide")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="TF32 rungs"):
        cc.fused_complex_dot(x, x, x, x, precision="float32", tile="wide")
    with pytest.raises(ValueError, match="no TF32 tile"):
        cc.fused_complex_dot(x, x, x, x, precision="default", tile="flat_m")
    with pytest.raises(KeyError):
        cc.tf32_config(64, 64, 64, "high", tile="flat_m")
