"""mcray_tpu quickstart: render, sweep, differentiate, shard.

Run from the repo root (on the CPU with 8 virtual devices; drop force_cpu to
run on a GPU host):

    python examples/quickstart.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")  # force_cpu
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax.numpy as jnp
import numpy as np

from mcray_tpu.config import small_test_config
from mcray_tpu.models.simulator import Simulator
from mcray_tpu.models.trainer import MaterialFitter
from mcray_tpu.ops.physics import ATTENUATION
from mcray_tpu.scene.compile import load_and_compile
from mcray_tpu.utils.image_io import save_png


def main():
    cfg = small_test_config(
        transducer_elements=64, samples_per_element=2,
        soft_scattering=True, trilinear_texture=True,
    )

    # --- 1. load a reference-format .scene and render a B-mode frame -------
    pack = load_and_compile("assets/sphere/sphere.scene", cfg)
    sim = Simulator(pack, cfg)
    out = sim.render_frame(seed=0)
    save_png("/tmp/quickstart_bmode.png", np.asarray(out["bmode"]))
    print("rendered", out["bmode"].shape, "-> /tmp/quickstart_bmode.png")

    # --- 2. Monte-Carlo compounding (one device call) ----------------------
    compound = sim.render_compound(range(4))
    print("compound frame max:", float(compound.max()))

    # --- 3. probe sweep: pose is a traced argument, no recompilation -------
    for dy in (0.0, 0.5):
        pose = jnp.asarray(pack.transducer_position) + jnp.array([0.0, dy, 0.0])
        sim.render_frame(seed=0, position=pose)
    print("swept 2 poses")

    # --- 4. differentiable fit: recover a perturbed material parameter -----
    key = jax.random.PRNGKey(0)

    def render(k, m):
        return sim._render(
            k, m, jnp.asarray(pack.transducer_position),
            jnp.asarray(pack.transducer_angles),
        )["bmode"]

    target = render(key, sim.materials)
    liver = 3
    start = np.asarray(sim.materials).copy()
    start[liver, ATTENUATION] *= 2.0
    fitter = MaterialFitter(
        render, jnp.asarray(start), target, learning_rate=5e-2,
        trainable=(ATTENUATION,), trainable_rows=[liver], fixed_key=key,
    )
    fitter.run(10, verbose=False)
    print(
        f"fit LIVER attenuation: start {start[liver, ATTENUATION]:.3f} -> "
        f"{float(fitter.state.materials[liver, ATTENUATION]):.3f} "
        f"(true {float(sim.materials[liver, ATTENUATION]):.3f})"
    )

    # --- 5. multi-device: scanline-sharded render on a Mesh ----------------
    from mcray_tpu.parallel.shard import ShardedRenderer, make_mesh

    sharded = ShardedRenderer(pack, cfg, mesh=make_mesh(8))
    b = sharded.render_frame(seed=0)["bmode"]
    print("sharded render matches single chip:",
          bool(np.allclose(np.asarray(b), np.asarray(out["bmode"]), atol=1e-5)))


if __name__ == "__main__":
    main()
