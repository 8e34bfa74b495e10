"""Roofline accounting: analytic FLOPs + device-memory bytes per pipeline
stage against the card's published peaks, so measured stage times convert
to a share of peak.

Peaks live in one table keyed by ``jax.Device.device_kind``; a device that
is not in the table is an error, not a default. Every stage here is f32
elementwise work outside the tensor cores, so the compute peak is the
card's non-tensor f32 rate. A transcendental (exp/log/sqrt) is counted as 1
FLOP; stages heavy in them understate their pipe occupancy.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 Tensor Core GPU data sheet (SXM5 part, dense rates): 67 TFLOP/s
# f32 (non-tensor), 495 TFLOP/s TF32 and 989 TFLOP/s bf16 tensor core, 3.35
# TB/s HBM3. The data sheet's rates assume the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_tensor_flops": 495e12,
        "bf16_tensor_flops": 989e12,
        "hbm_bytes_s": 3.35e12,
        "source": "NVIDIA H100 Tensor Core GPU data sheet, SXM5",
    },
}


def peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; raises for unknown devices."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add them to "
            "mcray_tpu.utils.roofline.PEAKS with their source"
        ) from None


# Moller-Trumbore per (ray, triangle) pair in the listed kernel: 2 cross
# products (12), 4 dot products (20), tvec (3), u/v/t scale (6), det recip
# (1), compares+selects (~8), running min/argmin update (~4).
MT_FLOPS = 54
# slab test per (ray, box): 6 mul + 6 sub + 8 min/max + 3 cmp
SLAB_FLOPS = 23
# march kernel work per (row, col, segment) cell with the default bitsum
# field, nearest texture: 4 row-match candidates (~24), sample point (6),
# 3 wrap indexes (~9), voxel id (4), 2 hashes (2x9 int ops), 2 bit-sum
# normals (2x6), gate + value (4), intensity exp + fma (3).
MARCH_FLOPS_PER_SAMPLE = 80


@dataclasses.dataclass
class StageCost:
    name: str
    flops: float       # executed FLOPs per frame (documented model)
    hbm_bytes: float   # device-memory traffic per frame (reads + writes)

    def summarize(self, seconds: float, device_kind: str) -> dict:
        pk = peaks(device_kind)
        t_compute = self.flops / pk["f32_flops"]
        t_mem = self.hbm_bytes / pk["hbm_bytes_s"]
        return {
            "stage": self.name,
            "ms": seconds * 1e3,
            "gflops": self.flops / 1e9,
            "hbm_mb": self.hbm_bytes / 1e6,
            "roofline_ms": max(t_compute, t_mem) * 1e3,
            "roofline_share": max(t_compute, t_mem) / seconds,
            "bound": "compute" if t_compute >= t_mem else "bandwidth",
        }


def intersect_cost(visited_per_bounce, tile_r: int, tile_t: int,
                   n_rays: int, n_clusters: int) -> StageCost:
    """Per-frame listed-intersect work. ``visited_per_bounce``: per bounce
    depth, the sum over packets of their cluster-list lengths (an upper
    bound on the clusters the kernel tests; the early stop only shrinks it).

    FLOPs = the dense (rays x clusters) slab prepass per bounce, plus per
    visited (packet, cluster): tile_r x tile_t Moller-Trumbore pairs and a
    tile_r slab re-check. Bytes = one 9 x tile_t f32 tile per visit plus the
    (packets x clusters) lists."""
    packets = n_rays // tile_r
    flops = 0.0
    bytes_ = 0.0
    for visited in visited_per_bounce:
        flops += n_rays * n_clusters * SLAB_FLOPS
        flops += visited * (tile_r * tile_t * MT_FLOPS + tile_r * SLAB_FLOPS)
        bytes_ += visited * 9 * tile_t * 4 + packets * n_clusters * 4 * 2
    return StageCost("intersect", flops, bytes_)


def march_cost(cfg, touched_cells: int, soa_bytes: int, n_cols: int) -> StageCost:
    """Output-stationary march kernel: ``touched_cells`` = the (row, col,
    segment) cells evaluated (each listed segment at every cell of its row
    tiles). Bytes: the segment SoA read per touching tile + the RF write."""
    return StageCost(
        "march",
        touched_cells * MARCH_FLOPS_PER_SAMPLE,
        soa_bytes + cfg.rf_rows * n_cols * 4,
    )
