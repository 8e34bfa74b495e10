"""Differentiable fit: recover acoustic material parameters from a target
B-mode image by gradient descent through the whole renderer.

The flagship differentiable workload: recover impedance, attenuation and
scatter density from a target B-mode via pixel-loss gradients. The
reference has no equivalent — its renderer is
non-differentiable C++. Here the loss is pixel MSE on the scan-converted
B-mode and gradients flow through scan conversion, envelope, convolution,
echo scatter-add, Beer-Lambert attenuation, Fresnel splits and the perturbed-
normal sampling into the (M, 8) material table (and optionally probe pose).

For useful gradients on the scattering threshold (mu1) enable
``cfg.soft_scattering`` / ``cfg.trilinear_texture`` (the straight-through
relaxation; SURVEY.md §7 "differentiating through discreteness").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import jax
import jax.numpy as jnp
import optax

from ..config import SimConfig
from ..ops import physics

Array = jax.Array

# Default trainable columns: impedance, attenuation, mu0, mu1, sigma.
# Specularity/shininess/thickness stay frozen (integer-ish semantics).
DEFAULT_TRAINABLE = (
    physics.IMPEDANCE,
    physics.ATTENUATION,
    physics.MU0,
    physics.MU1,
    physics.SIGMA,
)


def column_mask(n_materials: int, columns=DEFAULT_TRAINABLE, rows=None) -> Array:
    """Trainability mask. Restricting ``rows`` to the materials actually under
    fit matters with Adam: its per-parameter normalisation moves every masked
    parameter by ~lr regardless of gradient magnitude, so leaving a
    near-zero-gradient material (e.g. the reference scenes' GEL with
    attenuation 1e-8) trainable lets the optimiser wander it destructively."""
    mask = jnp.zeros((n_materials, 8), jnp.float32)
    row_sel = list(range(n_materials)) if rows is None else list(rows)
    for r in row_sel:
        mask = mask.at[r, list(columns)].set(1.0)
    return mask


@dataclasses.dataclass
class FitState:
    materials: Array
    opt_state: Any
    step: int = 0


class MaterialFitter:
    """Adam fit of the material table against a target B-mode.

    ``render_fn(key, materials) -> bmode`` abstracts over single-device
    (Simulator) and sharded (ShardedRenderer) execution: shard_map is
    differentiable, so the same loss/grad code drives both; under sharding
    the material-gradient psum over devices is inserted by AD.
    """

    def __init__(
        self,
        render_fn: Callable[..., Array],
        init_materials: Array,
        target: Array,
        learning_rate: float = 1e-2,
        trainable=DEFAULT_TRAINABLE,
        trainable_rows=None,
        n_frames_per_step: int = 1,
        fixed_key: Array | None = None,
        render_args: tuple = (),
    ):
        # fixed_key freezes the Monte-Carlo noise (same speckle realisation
        # for target and prediction) — the standard inverse-rendering setup;
        # without it the fit sees a speckle-decorrelation noise floor and
        # needs many frames per step to average it out.
        #
        # ``render_args``: extra pytrees threaded through the jitted step to
        # ``render_fn(key, materials, *render_args)``. Pass the renderer's
        # device state (e.g. Simulator._state) here instead of closing
        # render_fn over it, so its arrays are not baked into the
        # executable as constants (see simulator.scene_state).
        self.render_fn = render_fn
        self.render_args = render_args
        self.target = target
        # numpy closures inline as HLO literal constants at trace time —
        # cheap; device-array closures are the thing to avoid
        import numpy as np

        target_np = np.asarray(target)
        mask_np = np.asarray(
            column_mask(init_materials.shape[0], trainable, trainable_rows)
        )
        self.mask = jnp.asarray(mask_np)
        self.optimizer = optax.adam(learning_rate)
        self.state = FitState(
            materials=jnp.asarray(init_materials),
            opt_state=self.optimizer.init(jnp.asarray(init_materials)),
        )
        self.n_frames = n_frames_per_step
        self.fixed_key = fixed_key

        def loss_fn(materials, key, render_args):
            if self.n_frames == 1:
                pred = self.render_fn(key, materials, *render_args)
            else:
                # Average over MC frames to reduce speckle-gradient variance.
                keys = jax.random.split(key, self.n_frames)
                pred = jax.vmap(
                    lambda k: self.render_fn(k, materials, *render_args)
                )(keys).mean(0)
            return jnp.mean((pred - jnp.asarray(target_np)) ** 2)

        @jax.jit
        def step(state_materials, opt_state, key, render_args):
            mask = jnp.asarray(mask_np)
            loss, grads = jax.value_and_grad(loss_fn)(
                state_materials, key, render_args
            )
            grads = grads * mask
            updates, opt_state = self.optimizer.update(grads, opt_state, state_materials)
            materials = optax.apply_updates(state_materials, updates)
            # keep physical parameters positive
            materials = jnp.maximum(materials, 1e-4) * mask + materials * (1 - mask)
            return materials, opt_state, loss, grads

        self._step = lambda m, o, k: step(m, o, k, self.render_args)

    def run(self, n_steps: int, seed: int = 0, log_every: int = 10, verbose: bool = True):
        return _run_loop(self, n_steps, seed, log_every, verbose)


class PoseFitter:
    """Probe-pose registration: recover the probe position (and optionally
    angles) whose rendered B-mode matches a target.

    Two methods:

    - ``method="fd"`` (the robust registration method): central finite differences
      on a speckle-robust objective — pixel MSE between multi-scale
      Gaussian-blurred, K-frame compounded B-modes. On the sphere scene the
      *values* of this loss form a
      smooth bowl around the true pose, but its AD gradients are sign-noisy
      (65-70% sign agreement) and ~10x smaller than the secant slope —
      most pose sensitivity flows through discretenesses AD cannot see (the
      floor row-binning of add_echo, hit/miss boundaries, speckle
      micro-structure). Central differences on the smooth loss capture the
      macro slope directly; pose is only 3-6 dims, so the 2D+1 probe renders
      batch into ONE vmapped device call per step. The FD step ``delta``
      anneals from ``fd_delta`` to ``fd_delta_min`` (coarse first — robust to
      residual ripples — then fine). Recovers a 0.3-world-unit offset to
      <0.05 in ~20 Adam steps.

    - ``method="ad"``: Adam on AD gradients of plain pixel MSE. Kept as the
      machinery baseline; NOT a reliable registration method (see above).
      Round 4 attacked the diagnosed root cause (floor row-binning) with
      ``cfg.soft_row_binning``: gradient magnitude recovers fully (median
      |AD|/|secant| 0.035 -> 0.94) but sign agreement DROPS to 50% — the
      un-suppressed d(image)/d(time) channel is dominated by speckle
      decorrelation, so AD registration would need a speckle-invariant
      differentiable objective, not a binning fix.

    ``render_fn(key, position, angles) -> bmode``. For ``method="fd"`` the
    ``target`` must be the K-frame compound rendered with the SAME ``keys``
    (use :meth:`compound`); for ``method="ad"`` it is a single frame.

    The product loop this replaces: the reference's interactive probe
    movement (reference src/inputmanager.cpp, never wired in; SURVEY.md §3.4
    identifies the pose as the system's one dynamic input).
    """

    def __init__(
        self,
        render_fn,
        init_position: Array,
        init_angles: Array,
        target: Array,
        learning_rate: float = 5e-2,
        fit_angles: bool = False,
        fixed_key: Array | None = None,
        method: str = "ad",
        keys: Array | None = None,
        scales: tuple = (2.0, 4.0, 8.0),
        fd_delta: float = 0.06,
        fd_delta_min: float = 0.025,
        fd_decay: float = 0.95,
        fd_delta_angles: float = 1.0,
        lr_decay: float = 0.95,
        render_args: tuple = (),
    ):
        self.render_fn = render_fn
        self.render_args = render_args
        self.target = target
        self.fit_angles = fit_angles
        self.fixed_key = fixed_key
        self.method = method
        self.n_frames = 1
        # fd: decay the lr with the annealed FD delta — prevents the Adam
        # momentum overshoot past the optimum measured with a constant lr
        self.optimizer = (
            optax.adam(optax.exponential_decay(learning_rate, 1, lr_decay))
            if method == "fd"
            else optax.adam(learning_rate)
        )
        self._angles0 = jnp.asarray(init_angles)

        if method == "fd":
            if keys is None:
                keys = jax.random.split(jax.random.PRNGKey(42), 4)
            self._keys = keys
            self._scales = tuple(scales)
            self._fd = (float(fd_delta), float(fd_delta_min), float(fd_decay),
                        float(fd_delta_angles))
            self._build_fd(init_position, init_angles)
            return

        params = {"position": jnp.asarray(init_position)}
        if fit_angles:
            params["angles"] = jnp.asarray(init_angles)
        self.state = FitState(materials=params, opt_state=self.optimizer.init(params))

        import numpy as np

        target_np = np.asarray(target)
        angles0_np = np.asarray(self._angles0)

        def loss_fn(params, key, render_args):
            ang = params.get("angles", jnp.asarray(angles0_np))
            pred = self.render_fn(key, params["position"], ang, *render_args)
            return jnp.mean((pred - jnp.asarray(target_np)) ** 2)

        @jax.jit
        def step(params, opt_state, key, render_args):
            loss, grads = jax.value_and_grad(loss_fn)(params, key, render_args)
            updates, opt_state = self.optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state, loss, grads

        self._step = lambda p, o, k: step(p, o, k, self.render_args)

    @staticmethod
    def compound(render_fn, keys, position, angles):
        """K-frame compounded B-mode (one vmapped device call)."""
        return jax.vmap(lambda k: render_fn(k, position, angles))(
            jnp.asarray(keys)
        ).mean(0)

    def _build_fd(self, init_position, init_angles):
        import numpy as np

        from ..ops.imaging import gaussian_blur

        d = 6 if self.fit_angles else 3
        vec0 = jnp.concatenate(
            [jnp.asarray(init_position, jnp.float32)]
            + ([jnp.asarray(init_angles, jnp.float32)] if self.fit_angles else [])
        )
        params = {"position": vec0[:3]}
        if self.fit_angles:
            params["angles"] = vec0[3:]
        self.state = FitState(materials=params, opt_state=self.optimizer.init(vec0))

        # numpy closures (inlined HLO constants); device state rides
        # render_args — see MaterialFitter
        tmax_np = float(np.maximum(np.max(np.asarray(self.target)), 1e-20))
        target_bank_np = [
            np.asarray(gaussian_blur(jnp.asarray(self.target) / tmax_np, s))
            for s in self._scales
        ]
        keys_np = np.asarray(self._keys)
        scales = self._scales
        render_fn = self.render_fn
        angles0_np = np.asarray(self._angles0)
        fit_angles = self.fit_angles

        def unpack(vec):
            pos = vec[:3]
            ang = vec[3:6] if fit_angles else jnp.asarray(angles0_np)
            return pos, ang

        def loss_of(vec, render_args):
            pos, ang = unpack(vec)
            c = jax.vmap(lambda k: render_fn(k, pos, ang, *render_args))(
                jnp.asarray(keys_np)
            ).mean(0) / tmax_np
            return sum(
                jnp.mean((gaussian_blur(c, s) - jnp.asarray(tb)) ** 2)
                for s, tb in zip(scales, target_bank_np)
            )

        delta_ang = self._fd[3]

        @jax.jit
        def step(vec, opt_state, delta, render_args):
            # per-dim FD step: positions use `delta`, angles a fixed degree step
            dvec = jnp.full((d,), delta, jnp.float32)
            if fit_angles:
                dvec = dvec.at[3:].set(delta_ang)
            eye = jnp.eye(d, dtype=jnp.float32) * dvec[:, None]
            pts = jnp.concatenate([vec[None], vec[None] + eye, vec[None] - eye], 0)
            # (2d+1,) — ONE batched render call
            vals = jax.vmap(lambda v: loss_of(v, render_args))(pts)
            g = (vals[1 : d + 1] - vals[d + 1 :]) / (2.0 * dvec)
            updates, opt_state = self.optimizer.update(g, opt_state, vec)
            return optax.apply_updates(vec, updates), opt_state, vals[0], g

        self._fd_step = lambda v, o, dl: step(v, o, dl, self.render_args)
        self._fd_vec = vec0

    def run(self, n_steps: int, seed: int = 0, log_every: int = 10, verbose: bool = True):
        if self.method != "fd":
            return _run_loop(self, n_steps, seed, log_every, verbose)
        d0, dmin, decay, _ = self._fd
        losses = []
        vec, opt_state = self._fd_vec, self.state.opt_state
        for i in range(n_steps):
            delta = jnp.float32(max(dmin, d0 * decay**i))
            vec, opt_state, loss, g = self._fd_step(vec, opt_state, delta)
            losses.append(float(loss))
            if verbose and (i % log_every == 0 or i == n_steps - 1):
                print(
                    f"step {i}: loss {losses[-1]:.6g} |g| "
                    f"{float(jnp.linalg.norm(g)):.3g} delta {float(delta):.3f}"
                )
        self._fd_vec = vec
        params = {"position": vec[:3]}
        if self.fit_angles:
            params["angles"] = vec[3:]
        self.state = FitState(params, opt_state, self.state.step + n_steps)
        return losses

    @property
    def position(self):
        return self.state.materials["position"]

    @property
    def angles(self):
        return self.state.materials.get("angles", self._angles0)


def _run_loop(fitter, n_steps: int, seed: int, log_every: int, verbose: bool):
    losses = []
    for i in range(n_steps):
        if fitter.fixed_key is not None:
            key = fitter.fixed_key
        else:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), fitter.state.step)
        params, opt_state, loss, grads = fitter._step(
            fitter.state.materials, fitter.state.opt_state, key
        )
        fitter.state = FitState(params, opt_state, fitter.state.step + 1)
        losses.append(float(loss))
        if verbose and (i % log_every == 0 or i == n_steps - 1):
            gnorm = float(
                optax.global_norm(grads) if not isinstance(grads, jax.Array)
                else jnp.linalg.norm(grads)
            )
            print(f"step {fitter.state.step}: loss {losses[-1]:.6g} |g| {gnorm:.3g}")
    return losses
