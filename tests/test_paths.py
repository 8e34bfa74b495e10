"""The one backend choice (paths.choose_paths) and its Paths record."""

import dataclasses

import pytest

from mcray_tpu.config import SimConfig
from mcray_tpu.paths import BRUTE_CHUNK, Paths, choose_paths


@pytest.mark.parametrize("n_triangles", [0, 2220, 123224, 615176])
def test_gpu_kernels_at_every_scene_size(n_triangles):
    # the listed kernel beat XLA's brute force on both measured scenes
    p = choose_paths("gpu", n_triangles)
    assert p == Paths(intersect="listed", march="kernel")
    assert not p.interpret


@pytest.mark.parametrize("intersect", ["brute", "listed", "bvh"])
def test_gpu_forced_intersect(intersect):
    p = choose_paths("gpu", 123224, intersect=intersect)
    assert p.intersect == intersect and p.march == "kernel"
    # a brute force on the card is chunked; the others ignore the chunk
    assert p.intersect_chunk == (BRUTE_CHUNK if intersect == "brute" else 0)


@pytest.mark.parametrize("n_triangles", [2220, 123224])
def test_cpu_plain_paths(n_triangles):
    # the jnp paths the tests and --platform cpu use; never interpret mode
    p = choose_paths("cpu", n_triangles)
    assert p == Paths(intersect="brute", intersect_chunk=0, march="jnp")
    assert not p.interpret


def test_soft_row_binning_keeps_jnp_march():
    p = choose_paths("gpu", 123224, soft_row_binning=True)
    assert p.march == "jnp" and p.intersect == "listed"


@pytest.mark.parametrize("backend", ["rocm", "METAL", "cuda", ""])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError):
        choose_paths(backend, 2220)


@pytest.mark.parametrize(
    "field,value", [("intersect", "culled"), ("march", "pallas"), ("imaging", "mxu")]
)
def test_paths_rejects_unknown_values(field, value):
    with pytest.raises(ValueError):
        Paths(**{field: value})


def test_simulator_takes_backend_choice(sphere_pack):
    from mcray_tpu.models.simulator import Simulator

    pack, cfg = sphere_pack
    sim = Simulator(pack, cfg)
    assert sim.paths == choose_paths("cpu", pack.n_triangles)
    assert sim._state["packed"] is None and sim._state["bvh_arrays"] is None
    bvh = Simulator(pack, cfg, use_bvh=True)
    assert bvh.paths.intersect == "bvh" and bvh._state["bvh_arrays"] is not None
    listed = Simulator(pack, cfg, paths=Paths(intersect="listed", interpret=True))
    assert listed._state["packed"].n_slots >= pack.n_triangles


def test_config_rejects_unknown_scatter_rng():
    with pytest.raises(ValueError):
        SimConfig(scatter_rng="gaussian")
    assert dataclasses.replace(SimConfig(), scatter_rng="boxmuller").scatter_rng == "boxmuller"
