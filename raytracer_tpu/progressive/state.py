"""RenderState: the resumable progressive-render state pytree.

The reference's accumulation texture IS its checkpoint — the running average
survives frame to frame in GPU memory (static/shader.frag:387-404) and is
reset whenever the camera/scene changes (src/state.rs:343-346). Here that
state is an explicit pytree {accum, render_count, frame, key}: trivially
serializable (np.savez / orbax), trivially resumable, and bitwise
reproducible thanks to counter-based RNG.
"""

from __future__ import annotations

from raytracer_tpu.core import pytree
import jax
import jax.numpy as jnp


@pytree.dataclass
class RenderState:
    accum: jnp.ndarray  # (H, W, 3) f32 — running average (post-gamma, like the reference texture)
    render_count: jnp.ndarray  # () i32 — frames folded into accum, clamped at max_render_count
    frame: jnp.ndarray  # () i32 — monotonically increasing; folds into the RNG key
    key: jnp.ndarray  # base PRNG key for the whole progressive run

    @property
    def height(self) -> int:
        return self.accum.shape[0]

    @property
    def width(self) -> int:
        return self.accum.shape[1]


def init_render_state(width: int, height: int, key=None) -> RenderState:
    if key is None:
        key = jax.random.PRNGKey(0)
    return RenderState(
        accum=jnp.zeros((height, width, 3), jnp.float32),
        render_count=jnp.asarray(0, jnp.int32),
        frame=jnp.asarray(0, jnp.int32),
        # Copy: step() donates the whole state pytree, and donating the
        # caller's key array would delete a buffer the caller still owns.
        key=jnp.array(key),
    )


def reset_accumulation(state: RenderState) -> RenderState:
    """Restart the running average (camera/scene changed,
    src/state.rs:343-346) — the frame counter keeps advancing so RNG never
    replays."""
    return state.replace(
        accum=jnp.zeros_like(state.accum),
        render_count=jnp.asarray(0, jnp.int32),
    )


def save_render_state(path: str, state: RenderState) -> None:
    """Checkpoint to an .npz (the analog of the accumulation texture
    persisting across frames; unlike the reference, it survives the process)."""
    import numpy as np

    np.savez(
        path,
        accum=np.asarray(state.accum),
        render_count=np.asarray(state.render_count),
        frame=np.asarray(state.frame),
        key=np.asarray(state.key),
    )


def load_render_state(path: str) -> RenderState:
    import numpy as np

    with np.load(path) as data:
        return RenderState(
            accum=jnp.asarray(data["accum"]),
            render_count=jnp.asarray(data["render_count"]),
            frame=jnp.asarray(data["frame"]),
            key=jnp.asarray(data["key"]),
        )
