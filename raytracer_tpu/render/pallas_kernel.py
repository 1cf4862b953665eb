"""Pallas-Triton megakernel: the whole per-pixel path tracer in one kernel.

The GPU re-creation of static/shader.frag as one fused kernel: camera
ray-gen (shader.frag:342-351), the spp loop (360-383), the bounce loop
(297-339), the closest-hit sphere scan (136-196), branch-free materials
(210-286) and the sky miss (289-294). The spp average and sqrt gamma
(376-380) happen outside, on the linear sums the kernel emits.

Design (one GPU thread per pixel, like the fragment shader):

- A 1-D grid over blocks of ``block`` pixels of the (band of the) image,
  flattened row-major. One lane owns one pixel; padding lanes past the
  last pixel are never alive and their outputs are sliced off.
- ONE ``while_loop`` per block runs every (sample, bounce) of its pixels
  with PATH REGENERATION: a lane whose path terminates (sky, absorption,
  Russian roulette, depth) folds its contribution into its pixel's sums and
  starts its next sample in place, so a block's warps stay busy until
  its longest pixel is done instead of idling at every sample boundary.
  Ray state and the per-pixel sums live in registers for the whole loop.
- The scene is one f32 table in global memory, 16 floats per sphere,
  padded to a power of two. The closest-hit scan is a ``fori_loop`` over
  spheres reading four uniform scalars per step (L1-resident); the
  winner's material row is fetched with one per-lane gather.
- RNG is a counter-based integer hash (lowbias32) keyed on (absolute
  pixel, seed, sample, bounce, draw): bitwise deterministic, independent
  of ``block`` and of how the grid is split across launches or devices.
- Out go per-pixel linear RGB sums plus the sample count, optional
  adaptive-sampling luminance sums, and an int32 segment count per block.
  No state passes between blocks and nothing is atomic.

The debug overlay (cursor marker / selection outline, shader.frag:306-318)
runs in the kernel when ``opts.enable_debug``. The AOV images
(normal/depth/uuid/front) stay on the jnp tracer (render/debug.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer_tpu.camera.camera import DerivedCamera
from raytracer_tpu.core.sampling import R2_ALPHAS_4D, R2_ALPHAS_B0, alphas_fixed32
from raytracer_tpu.render.options import MAX_T, MIN_T, TraceOptions
from raytracer_tpu.scene.spheres import Scene

#: pixels per program, one lane per pixel: the best of the BLOCK sweep on
#: the card recorded in PERF.md (32 lanes = one warp, one pixel a thread)
DEFAULT_BLOCK = 32

#: floats per sphere row of the scene table
TAB_STRIDE = 16
(_CX, _CY, _CZ, _R2, _INV_R, _MAT, _AR, _AG, _AB, _FUZZ, _REFR,
 _UUID) = range(12)

TWO_PI = 6.2831853071795864
INV_24 = 1.0 / 16777216.0  # 2^-24
#: stratified-sampler alphas as 32-bit fixed-point integers (the exact
#: representation _r2_fixed consumes; shared with core/sampling.r2_point)
_A4_FIX = alphas_fixed32(R2_ALPHAS_4D)
_AB0_FIX = alphas_fixed32(R2_ALPHAS_B0)
#: RNG counters per bounce (7 material draws + the RR roll); a sample's
#: counter block is 4 camera counters followed by max_depth bounce blocks
_DRAWS_PER_BOUNCE = 8


def interpret_mode() -> bool:
    """Pallas runs interpreted on the CPU (tests) and compiled through
    Triton on the GPU. Any other platform is an error, never a silent
    interpreter."""
    backend = jax.default_backend()
    if backend == "cpu":
        return True
    if backend == "gpu":
        return False
    raise ValueError(
        f"the Pallas kernel runs on 'gpu' (or interpreted on 'cpu'), "
        f"not on {backend!r}"
    )


# --- counter-based in-kernel RNG --------------------------------------------


def _lowbias32(x):
    """lowbias32 integer hash (public constants by the Hash Prospector)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _hash32(pix, ctr, salt: int):
    """The raw 32-bit hash stream: hash(pixel ⊕ golden·(ctr+salt))."""
    c = (jnp.asarray(ctr, jnp.uint32) + jnp.uint32(salt)) * jnp.uint32(
        0x9E3779B9
    )
    return _lowbias32(pix ^ c)


def _to_u01(h):
    """Top 24 bits of a uint32 → f32 in [0, 1)."""
    return (h >> 8).astype(jnp.float32) * INV_24


def _u01(pix, ctr, salt: int):
    """One uniform [0,1) draw per lane."""
    return _to_u01(_hash32(pix, ctr, salt))


def _r2_fixed(pix, rot, d: int, s_u, a_fix: int):
    """The s-th Kronecker point of dim ``d`` in 32-bit FIXED point: the
    per-pixel hash is the Cranley-Patterson rotation and frac(cp + s·alpha)
    becomes (cp_fix + s·a_fix) mod 2^32 — exact for every sample index,
    where an f32 recurrence would quantize once s·alpha outgrows the
    24-bit mantissa. Same construction as core/sampling.r2_point (shared
    alphas_fixed32); the rotations come from a different RNG, so the two
    streams are statistically, not bitwise, equal."""
    return _to_u01(_hash32(pix, rot, d) + s_u * jnp.uint32(a_fix))


def _seed_from_key(key):
    """The kernel's 32-bit seed from a jax PRNG key."""
    kd = jax.random.key_data(key).astype(jnp.uint32)
    return (kd[0] ^ _lowbias32(kd[1])).astype(jnp.int32)


# --- small vector helpers over SoA triples -----------------------------------


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize3(x, y, z, eps=1e-20):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, eps))
    return x * inv, y * inv, z * inv


def _unit_sphere(pix, ctr, salt):
    """random_in_unit_sphere, reference distribution (shader.frag:114-121)."""
    hx = _u01(pix, ctr, salt) * 2.0 - 1.0
    phi = _u01(pix, ctr, salt + 1) * TWO_PI
    r = jnp.cbrt(_u01(pix, ctr, salt + 2))
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - hx * hx))
    return r * s * jnp.sin(phi), r * s * jnp.cos(phi), r * hx


def _unit_vec(pix, ctr, salt):
    x, y, z = _unit_sphere(pix, ctr, salt)
    return _normalize3(x, y, z)


def _quad(ox, oy, oz, dx, dy, dz, a, cx, cy, cz, r2):
    """Half-b ray/sphere quadratic (shader.frag:145-165) in q = t·|d|²
    space: returns (nb, sq, ok) with nb = -half_b, sq = sqrt(disc) and
    ok = disc >= 0, so the roots are q = nb ∓ sq. The scan and the split
    scan's self-test share this so their arithmetic is identical."""
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    nb = -_dot3(ocx, ocy, ocz, dx, dy, dz)
    cc = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - r2
    disc = nb * nb - a * cc
    return nb, jnp.sqrt(jnp.maximum(disc, 0.0)), disc >= 0.0


# --- the kernel ---------------------------------------------------------------


def _make_kernel(*, width: int, height: int, band_h: int, spp: int,
                 opts: TraceOptions, n_spheres: int, g_full: int,
                 block: int, adaptive: bool):
    """Build the kernel body for one static configuration.

    Spheres [0, g_full) run the full near→far root fallback; spheres
    [g_full, n_spheres) are statically known never to contain a ray
    origin (see _containable_split) and test the near root only, with an
    exact far-root self-test of the lane's last-hit sphere covering the
    one legitimate far-root case left (a path re-entering the sphere it
    just bounced off)."""
    max_depth = opts.max_depth
    draws_per_sample = 4 + max_depth * _DRAWS_PER_BOUNCE
    n_pix = width * band_h
    inv_w = 1.0 / width
    inv_h = 1.0 / height
    stratified = opts.sampler == "stratified"
    has_self = g_full < n_spheres
    rr_depth = opts.russian_roulette_depth

    def kernel(cam_ref, seed_ref, tab_ref, *refs):
        if adaptive:
            bud_ref, out_ref, stat_ref, seg_ref = refs
        else:
            out_ref, seg_ref = refs
        # camera uniforms — the descendant of the reference's uniform ABI
        # (src/webgl.rs:279-593)
        ox0, oy0, oz0 = cam_ref[0], cam_ref[1], cam_ref[2]
        llx, lly, llz = cam_ref[3], cam_ref[4], cam_ref[5]
        hx, hy, hz = cam_ref[6], cam_ref[7], cam_ref[8]
        vx, vy, vz = cam_ref[9], cam_ref[10], cam_ref[11]
        ux, uy, uz = cam_ref[12], cam_ref[13], cam_ref[14]
        # the lens basis (u, v) spans the aperture disc
        lvx, lvy, lvz = cam_ref[15], cam_ref[16], cam_ref[17]
        lens_radius = cam_ref[18]
        base_seed = seed_ref[0]
        sample_offset = seed_ref[1]
        row_offset = seed_ref[2]

        lane = pl.program_id(0) * block + jax.lax.broadcasted_iota(
            jnp.int32, (block,), 0
        )
        in_img = lane < n_pix
        px_i = lane % width
        py_i = lane // width + row_offset  # absolute image row
        px = px_i.astype(jnp.float32)
        py = py_i.astype(jnp.float32)
        gid = (py_i * width + px_i).astype(jnp.uint32)
        pix = _lowbias32(gid ^ base_seed.astype(jnp.uint32))
        if adaptive:
            budget = bud_ref[...]
        else:
            budget = jnp.full((block,), spp, jnp.int32)
        zero = jnp.zeros((block,), jnp.float32)
        one = jnp.ones((block,), jnp.float32)

        def sample_index(s):
            return (sample_offset + s).astype(jnp.uint32)

        def gen_ray(s):
            """Camera ray of this lane's sample ``s``: draws 0-3 of the
            sample's counter block (shader.frag:342-351, 365-369), or the
            stratified 4-D R2 point under a per-pixel rotation at counter
            -4 (disjoint from every per-sample block)."""
            s_u = sample_index(s)
            if stratified:
                rot = jnp.uint32(0xFFFFFFFC)
                u0, u1, u2, u3 = (
                    _r2_fixed(pix, rot, d, s_u, _A4_FIX[d]) for d in range(4)
                )
            else:
                ctr0 = s_u * jnp.uint32(draws_per_sample)
                u0, u1, u2, u3 = (_u01(pix, ctr0, d) for d in range(4))
            st_s = (px + 0.5 + u0) * inv_w
            st_t = (py + 0.5 + u1) * inv_h
            ang = u2 * TWO_PI
            rad = lens_radius * jnp.sqrt(u3)
            rdx = rad * jnp.cos(ang)
            rdy = rad * jnp.sin(ang)
            ox = ox0 + ux * rdx + lvx * rdy
            oy = oy0 + uy * rdx + lvy * rdy
            oz = oz0 + uz * rdx + lvz * rdy
            dx = llx + st_s * hx + st_t * vx - ox
            dy = lly + st_s * hy + st_t * vy - oy
            dz = llz + st_s * hz + st_t * vz - oz
            return ox, oy, oz, dx, dy, dz

        def row(idx, col):
            """Per-lane gather of one column of the scene table."""
            return tab_ref[idx * TAB_STRIDE + col]

        def closest_hit(ox, oy, oz, dx, dy, dz, a, min_q, last):
            """Closest-hit scan (shader.frag:145-196) over every sphere.
            Ties keep the lower index; the initial best is MAX_T, the
            reference's per-ray t_max."""

            def scan(full):
                def body(k, carry):
                    best_q, best_i = carry
                    base = k * TAB_STRIDE
                    nb, sq, ok = _quad(
                        ox, oy, oz, dx, dy, dz, a, tab_ref[base + _CX],
                        tab_ref[base + _CY], tab_ref[base + _CZ],
                        tab_ref[base + _R2],
                    )
                    q = nb - sq
                    if full:
                        q = jnp.where(q >= min_q, q, nb + sq)
                    upd = ok & (q >= min_q) & (q < best_q)
                    return (jnp.where(upd, q, best_q),
                            jnp.where(upd, k, best_i))

                return body

            carry = (MAX_T * a, jnp.full((block,), -1, jnp.int32))
            if g_full > 0:
                carry = jax.lax.fori_loop(0, g_full, scan(True), carry)
            if n_spheres > g_full:
                carry = jax.lax.fori_loop(g_full, n_spheres, scan(False),
                                          carry)
            best_q, best_i = carry
            if has_self:
                li = jnp.maximum(last, 0)
                nb, sq, ok = _quad(
                    ox, oy, oz, dx, dy, dz, a, row(li, _CX), row(li, _CY),
                    row(li, _CZ), row(li, _R2),
                )
                qf = nb + sq
                self_ok = (last >= 0) & ok & (qf >= min_q) & (qf < best_q)
                best_q = jnp.where(self_ok, qf, best_q)
                best_i = jnp.where(self_ok, last, best_i)
            return best_q, best_i

        def body(state):
            (ox, oy, oz, dx, dy, dz, cr, cg, cb, ar, ag, ab_, s, i, alive,
             segs, *rest) = state
            if adaptive:
                lum, lum2, *rest = rest
            last = rest[0] if has_self else None
            s_u = sample_index(s)
            ctr = (s_u * jnp.uint32(draws_per_sample) + jnp.uint32(4)
                   + i.astype(jnp.uint32) * jnp.uint32(_DRAWS_PER_BOUNCE))
            segs = segs + alive.astype(jnp.int32)

            a = _dot3(dx, dy, dz, dx, dy, dz)
            min_q = MIN_T * a
            best_q, best_i = closest_hit(ox, oy, oz, dx, dy, dz, a, min_q,
                                         last)
            hit = best_i >= 0
            wi = jnp.maximum(best_i, 0)
            scx, scy, scz = row(wi, _CX), row(wi, _CY), row(wi, _CZ)
            inv_r = row(wi, _INV_R)
            mat = row(wi, _MAT)
            al_r, al_g, al_b = row(wi, _AR), row(wi, _AG), row(wi, _AB)
            fuzz = row(wi, _FUZZ)
            refr = row(wi, _REFR)
            best_t = best_q / a

            # hit point + front-face-corrected normal (shader.frag:166-171)
            hpx = ox + best_t * dx
            hpy = oy + best_t * dy
            hpz = oz + best_t * dz
            nx = (hpx - scx) * inv_r
            ny = (hpy - scy) * inv_r
            nz = (hpz - scz) * inv_r
            front = _dot3(dx, dy, dz, nx, ny, nz) < 0.0
            sgn = jnp.where(front, 1.0, -1.0)
            nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

            live_hit = alive & hit
            if opts.enable_debug:
                # in-kernel debug overlay (shader.frag:306-318): a solid
                # blue marker within 0.1 of the cursor and a solid red
                # outline on the selected sphere at grazing incidence end
                # the sample with a FIXED color
                dcx = hpx - cam_ref[19]
                dcy = hpy - cam_ref[20]
                dcz = hpz - cam_ref[21]
                cursor_hit = live_hit & (
                    _dot3(dcx, dcy, dcz, dcx, dcy, dcz) < 0.01
                )
                outline = (
                    live_hit & ~cursor_hit
                    & (row(wi, _UUID) == cam_ref[22])
                    & (_dot3(dx, dy, dz, nx, ny, nz) > -0.05)
                )

            # --- scatter (shader.frag:210-286), branch-free ---
            uvx, uvy, uvz = _unit_vec(pix, ctr, 0)
            usx, usy, usz = _unit_sphere(pix, ctr, 3)
            glass_u = _u01(pix, ctr, 6)
            if stratified:
                # FIRST-bounce stratified draws (core/sampling.py
                # R2_ALPHAS_B0) under per-pixel rotations at counter -8:
                # the diffuse direction via the Archimedes (hx, phi) map
                # and the glass Schlick roll; deeper bounces stay hashed
                rot_b = jnp.uint32(0xFFFFFFF8)
                b_hx = _r2_fixed(pix, rot_b, 0, s_u, _AB0_FIX[0]) * 2.0 - 1.0
                b_phi = _r2_fixed(pix, rot_b, 1, s_u, _AB0_FIX[1]) * TWO_PI
                b_s = jnp.sqrt(jnp.maximum(0.0, 1.0 - b_hx * b_hx))
                first = i == 0
                uvx = jnp.where(first, b_s * jnp.sin(b_phi), uvx)
                uvy = jnp.where(first, b_s * jnp.cos(b_phi), uvy)
                uvz = jnp.where(first, b_hx, uvz)
                glass_u = jnp.where(
                    first, _r2_fixed(pix, rot_b, 2, s_u, _AB0_FIX[2]),
                    glass_u,
                )

            # DIFFUSE
            ddx = nx + uvx
            ddy = ny + uvy
            ddz = nz + uvz
            if opts.near_zero_guard:
                nz_mask = (
                    (jnp.abs(ddx) < 1e-8) & (jnp.abs(ddy) < 1e-8)
                    & (jnp.abs(ddz) < 1e-8)
                )
                ddx = jnp.where(nz_mask, nx, ddx)
                ddy = jnp.where(nz_mask, ny, ddy)
                ddz = jnp.where(nz_mask, nz, ddz)

            # METAL: reflect + fuzz
            d_dot_n = _dot3(dx, dy, dz, nx, ny, nz)
            mdx = dx - 2.0 * d_dot_n * nx + fuzz * usx
            mdy = dy - 2.0 * d_dot_n * ny + fuzz * usy
            mdz = dz - 2.0 * d_dot_n * nz + fuzz * usz
            metal_ok = _dot3(nx, ny, nz, mdx, mdy, mdz) > 0.0

            # GLASS: Snell + TIR + Schlick roulette
            ratio = jnp.where(front, 1.0 / refr, refr)
            udx, udy, udz = _normalize3(dx, dy, dz)
            cos_t = jnp.minimum(-_dot3(udx, udy, udz, nx, ny, nz), 1.0)
            sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
            cannot = ratio * sin_t > 1.0
            r0 = (1.0 - ratio) / (1.0 + ratio)
            r0 = r0 * r0
            one_m = 1.0 - cos_t
            one_m2 = one_m * one_m
            schlick = r0 + (1.0 - r0) * one_m2 * one_m2 * one_m
            reflects = cannot | (schlick > glass_u)
            rpx = ratio * (udx + cos_t * nx)
            rpy = ratio * (udy + cos_t * ny)
            rpz = ratio * (udz + cos_t * nz)
            sk = jnp.sqrt(
                jnp.maximum(0.0, 1.0 - _dot3(rpx, rpy, rpz, rpx, rpy, rpz))
            )
            ud_dot_n = _dot3(udx, udy, udz, nx, ny, nz)
            gdx = jnp.where(reflects, udx - 2.0 * ud_dot_n * nx, rpx - sk * nx)
            gdy = jnp.where(reflects, udy - 2.0 * ud_dot_n * ny, rpy - sk * ny)
            gdz = jnp.where(reflects, udz - 2.0 * ud_dot_n * nz, rpz - sk * nz)

            is_diffuse = mat < 0.5
            is_metal = (mat >= 0.5) & (mat < 1.5)
            is_glass = (mat >= 1.5) & (mat < 2.5)
            ndx = jnp.where(is_diffuse, ddx, jnp.where(is_metal, mdx, gdx))
            ndy = jnp.where(is_diffuse, ddy, jnp.where(is_metal, mdy, gdy))
            ndz = jnp.where(is_diffuse, ddz, jnp.where(is_metal, mdz, gdz))
            did_scatter = is_diffuse | (is_metal & metal_ok) | is_glass

            # --- terminations and continuations -------------------------
            miss = alive & ~hit
            scat = live_hit & did_scatter
            # sky on miss (shader.frag:289-294, 331-335)
            sky_t = 0.5 * (udy + 1.0)
            con_r = jnp.where(miss, cr * (1.0 - 0.5 * sky_t), zero)
            con_g = jnp.where(miss, cg * (1.0 - 0.3 * sky_t), zero)
            con_b = jnp.where(miss, cb, zero)
            if opts.enable_debug:
                scat = scat & ~cursor_hit & ~outline
                con_r = jnp.where(outline, one, jnp.where(cursor_hit, zero,
                                                          con_r))
                con_g = jnp.where(cursor_hit | outline, zero, con_g)
                con_b = jnp.where(cursor_hit, one, jnp.where(outline, zero,
                                                             con_b))

            cr = jnp.where(scat, cr * al_r, cr)
            cg = jnp.where(scat, cg * al_g, cg)
            cb = jnp.where(scat, cb * al_b, cb)
            if rr_depth > 0:
                # unbiased termination: survive with p = max(throughput)
                p_surv = jnp.clip(jnp.maximum(cr, jnp.maximum(cg, cb)),
                                  0.05, 1.0)
                roll = i >= rr_depth
                survive = ~roll | (_u01(pix, ctr, 7) < p_surv)
                boost = jnp.where(roll & survive & scat, 1.0 / p_surv, 1.0)
                cr, cg, cb = cr * boost, cg * boost, cb * boost
                scat = scat & survive

            # depth exhaustion (shader.frag:338 quirk): the reference
            # returns the throughput, the book returns black
            exhausted = scat & (i >= max_depth - 1)
            if not opts.exhaust_black:
                con_r = jnp.where(exhausted, cr, con_r)
                con_g = jnp.where(exhausted, cg, con_g)
                con_b = jnp.where(exhausted, cb, con_b)
            scat_cont = scat & ~exhausted

            # con_* are zero on lanes whose sample goes on
            ar = ar + con_r
            ag = ag + con_g
            ab_ = ab_ + con_b
            done = alive & ~scat_cont
            if adaptive:
                ls = (con_r + con_g + con_b) * (1.0 / 3.0)
                lum = lum + jnp.where(done, ls, zero)
                lum2 = lum2 + jnp.where(done, ls * ls, zero)
            s = s + done.astype(jnp.int32)
            regen = done & (s < budget)
            nox, noy, noz, ndx2, ndy2, ndz2 = gen_ray(s)

            ox = jnp.where(regen, nox, jnp.where(scat_cont, hpx, ox))
            oy = jnp.where(regen, noy, jnp.where(scat_cont, hpy, oy))
            oz = jnp.where(regen, noz, jnp.where(scat_cont, hpz, oz))
            dx = jnp.where(regen, ndx2, jnp.where(scat_cont, ndx, dx))
            dy = jnp.where(regen, ndy2, jnp.where(scat_cont, ndy, dy))
            dz = jnp.where(regen, ndz2, jnp.where(scat_cont, ndz, dz))
            cr = jnp.where(regen, one, cr)
            cg = jnp.where(regen, one, cg)
            cb = jnp.where(regen, one, cb)
            i = jnp.where(regen, 0, jnp.where(scat_cont, i + 1, i))
            alive = scat_cont | regen
            out = [ox, oy, oz, dx, dy, dz, cr, cg, cb, ar, ag, ab_, s, i,
                   alive, segs]
            if adaptive:
                out += [lum, lum2]
            if has_self:
                out.append(jnp.where(regen, -1,
                                     jnp.where(scat_cont, best_i, last)))
            return tuple(out)

        def cond(state):
            return jnp.max(state[14].astype(jnp.int32)) > 0

        s0 = jnp.zeros((block,), jnp.int32)
        init = [*gen_ray(s0), one, one, one, zero, zero, zero, s0, s0,
                in_img & (budget > 0), s0]
        if adaptive:
            init += [zero, zero]
        if has_self:
            init.append(jnp.full((block,), -1, jnp.int32))
        final = jax.lax.while_loop(cond, body, tuple(init))
        out_ref[0, :] = final[9]
        out_ref[1, :] = final[10]
        out_ref[2, :] = final[11]
        out_ref[3, :] = final[12].astype(jnp.float32)  # samples taken
        if adaptive:
            stat_ref[0, :] = final[16]
            stat_ref[1, :] = final[17]
        seg_ref[...] = jnp.sum(final[15], keepdims=True)

    return kernel


# --- host-side tables ---------------------------------------------------------


def _pad_spheres(n: int) -> int:
    """Scene-table rows: the next power of two (at least 8)."""
    return max(8, 1 << (max(n, 1) - 1).bit_length())


def _scene_table(scene: Scene, uuid) -> jnp.ndarray:
    """(S_pad·16,) f32 row table: [cx, cy, cz, r², 1/r (signed), material,
    albedo rgb, fuzz, refraction index, uuid, 0…]. ``uuid`` is each slot's
    user-facing sphere index (see _apply_split). Inactive and padding rows are geometrically unhittable:
    center 0 and r² = -1 make the discriminant negative for every ray
    (Cauchy-Schwarz). The signed 1/r reproduces the negative-radius normal
    flip (shader.frag:170) and stays finite for r == 0."""
    act = scene.active > 0.0
    r = scene.radius
    n = scene.count
    cols = [
        jnp.where(act[:, None], scene.center, 0.0),
        jnp.where(act, r * r, -1.0)[:, None],
        jnp.where(r == 0.0, 1.0, 1.0 / jnp.where(r == 0.0, 1.0, r))[:, None],
        scene.material_type.astype(jnp.float32)[:, None],
        scene.albedo,
        scene.fuzz[:, None],
        scene.refraction_index[:, None],
        jnp.asarray(uuid, jnp.float32)[:, None],
    ]
    table = jnp.concatenate(cols, axis=1).astype(jnp.float32)
    s_pad = _pad_spheres(n)
    table = jnp.pad(table, ((0, s_pad - n), (0, TAB_STRIDE - table.shape[1])))
    table = table.at[n:, _R2].set(-1.0).at[n:, _INV_R].set(1.0)
    return table.reshape(-1)


def _camera_uniforms(dcam: DerivedCamera, debug=None) -> jnp.ndarray:
    """(32,) f32: origin, lower-left, horizontal, vertical, u, v, lens
    radius, then (debug) cursor point and selected sphere id."""
    parts = [dcam.origin, dcam.lower_left_corner, dcam.horizontal,
             dcam.vertical, dcam.u, dcam.v, dcam.lens_radius[None]]
    if debug is not None:
        parts.append(jnp.asarray(debug.cursor_point, jnp.float32))
        parts.append(jnp.asarray(debug.selected_object, jnp.float32)[None])
    u = jnp.concatenate(parts).astype(jnp.float32)
    return jnp.pad(u, (0, 32 - u.shape[0]))


def _containable_split(scene: Scene, dcam: DerivedCamera, opts: TraceOptions):
    """Static scene analysis: which spheres can contain a ray origin?

    The quadratic's far-root fallback (shader.frag:157-165) is only ever
    the closest legitimate hit when the ray STARTS strictly inside the
    sphere. Ray origins are (a) the camera origin ± its lens disc and
    (b) hit points, which lie on sphere surfaces. So sphere j is
    "containable" iff it is glass, another ACTIVE sphere's surface passes
    through its interior, or the camera's lens disc reaches inside it.
    Everything else can skip the far root in the scan.

    Returns ``(perm, g_full)`` — a permutation putting containable spheres
    first (None when already so) and their count — or ``None`` when the
    scene/camera are traced values, the analysis is disabled, or every
    sphere needs the full logic.

    Caveat (FIDELITY.md): hit points computed in f32 can land O(1e-4·scale)
    inside a sphere merely TANGENT to the one that was hit; the pairwise
    test keeps a scale-relative margin so exact tangencies stay
    containable.
    """
    flags = _containable_flags(scene, dcam, opts)
    if flags is None:
        return None
    g_full = int(flags.sum())
    if g_full >= flags.shape[0]:
        return None
    perm = np.argsort(~flags, kind="stable")
    if np.array_equal(perm, np.arange(perm.shape[0])):
        perm = None
    return perm, g_full


def _containable_flags(scene: Scene, dcam: DerivedCamera,
                       opts: TraceOptions):
    """Per-sphere bool array of :func:`_containable_split`'s analysis, or
    None for traced inputs / disabled analysis."""
    if not opts.split_scan:
        return None
    inputs = (scene.center, scene.radius, scene.active, scene.material_type,
              dcam.origin, dcam.lens_radius)
    if any(isinstance(x, jax.core.Tracer) for x in inputs):
        return None  # traced values inside jit — no static analysis
    c, r, act, mat, cam, lens = jax.device_get(inputs)
    c = np.asarray(c, np.float64)
    r = np.abs(np.asarray(r, np.float64))
    act = np.asarray(act, np.float64) > 0.0
    cam = np.asarray(cam, np.float64)
    lens = float(lens)
    from raytracer_tpu.scene import materials

    # f32 hit points on sphere i wander off its surface by roughly
    # eps32·(|c_i| + r_i); delta is that bound with 10x headroom
    delta = 1e-5 * (np.linalg.norm(c, axis=-1) + r + 1.0)
    containable = act & (mat == materials.GLASS)
    cam_delta = 1e-5 * (np.linalg.norm(cam) + 1.0)
    containable |= act & (
        np.linalg.norm(c - cam[None, :], axis=-1)
        < r + lens + cam_delta + 1e-4
    )
    # another active sphere's surface inside: shell_i crosses ball_j iff
    # | |ci-cj| - ri | < rj (inflated by delta_i)
    dist = np.linalg.norm(c[:, None, :] - c[None, :, :], axis=-1)
    crosses = np.abs(dist - r[:, None]) < (r[None, :] + delta[:, None]
                                           + 1e-4)
    np.fill_diagonal(crosses, False)
    containable |= act & (crosses & act[:, None]).any(axis=0)
    return containable


def _apply_split(scene: Scene, split):
    """(scene, uuid, g_full) after the containable permutation; ``uuid``
    is each slot's user-facing sphere index as f32 (for the debug
    outline)."""
    if split is None:
        g_full = scene.count
    else:
        perm, g_full = split
        if perm is not None:
            perm = np.asarray(perm)
            scene = jax.tree_util.tree_map(lambda a: a[perm], scene)
            return scene, jnp.asarray(perm, jnp.float32), g_full
    return scene, jnp.arange(scene.count, dtype=jnp.float32), g_full


# --- launches -----------------------------------------------------------------


def trace_band(scene: Scene, uuid, dcam: DerivedCamera, debug, seed,
               sample_offset, row_offset, *, width: int, height: int,
               band_h: int, spp: int, opts: TraceOptions, g_full: int,
               block: int = DEFAULT_BLOCK, num_warps: int | None = None,
               budget=None):
    """One kernel launch over ``band_h`` image rows starting at absolute
    row ``row_offset``, samples [sample_offset, sample_offset + spp).

    Returns ``(sums, stats, segs)``: ``sums`` (4, P) linear [r, g, b]
    sums and the per-pixel sample count for the band's P = width·band_h
    pixels (row-major); ``stats`` (2, P) per-pixel [Σlum, Σlum²] when
    ``budget`` — a (P,) int32 per-pixel sample budget plane — is given,
    else None; ``segs`` (n_blocks,) int32 segment counts. ``num_warps``
    defaults to one thread per pixel."""
    if block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    adaptive = budget is not None
    n_pix = width * band_h
    n_blocks = pl.cdiv(n_pix, block)
    p_pad = n_blocks * block
    kernel = _make_kernel(
        width=width, height=height, band_h=band_h, spp=spp, opts=opts,
        n_spheres=scene.count, g_full=g_full, block=block, adaptive=adaptive,
    )
    seeds = jnp.stack([
        jnp.asarray(seed, jnp.int32), jnp.asarray(sample_offset, jnp.int32),
        jnp.asarray(row_offset, jnp.int32), jnp.int32(0),
    ])
    args = [_camera_uniforms(dcam, debug if opts.enable_debug else None),
            seeds, _scene_table(scene, uuid)]
    in_specs = [pl.no_block_spec] * 3
    lane_spec = pl.BlockSpec((block,), lambda b: (b,))
    if adaptive:
        args.append(jnp.pad(budget.astype(jnp.int32), (0, p_pad - n_pix)))
        in_specs.append(lane_spec)
    out_shape = [jax.ShapeDtypeStruct((4, p_pad), jnp.float32)]
    out_specs = [pl.BlockSpec((4, block), lambda b: (0, b))]
    if adaptive:
        out_shape.append(jax.ShapeDtypeStruct((2, p_pad), jnp.float32))
        out_specs.append(pl.BlockSpec((2, block), lambda b: (0, b)))
    out_shape.append(jax.ShapeDtypeStruct((n_blocks,), jnp.int32))
    out_specs.append(pl.BlockSpec((1,), lambda b: (b,)))
    outs = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=in_specs,
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps or max(1, block // 32), num_stages=1
        ),
        interpret=interpret_mode(),
        name="path_trace",
    )(*args)
    sums = outs[0][:, :n_pix]
    stats = outs[1][:, :n_pix] if adaptive else None
    return sums, stats, outs[-1]


def _seg_pair(counts) -> jnp.ndarray:
    """int32 segment counts → exact (2,) int32 [hi, lo] total (value
    hi·4096 + lo): exact far past int32 range, so equal work compares
    equal however it was split into blocks, launches or shards."""
    t = counts.astype(jnp.int32)
    return jnp.stack([jnp.sum(t >> 12), jnp.sum(t & 0xFFF)])


def _seg_value(pair) -> jnp.ndarray:
    """(2,) int32 segment pair → f32 total, rounded once at the end."""
    hi = pair[0] + (pair[1] >> 12)
    lo = pair[1] & 0xFFF
    return hi.astype(jnp.float32) * 4096.0 + lo.astype(jnp.float32)


def _band_image(planes, width: int, band_h: int):
    """(C, P) per-pixel planes → (band_h, W, C)."""
    return planes.reshape(planes.shape[0], band_h, width).transpose(1, 2, 0)


def _gamma(image, gamma: bool):
    return jnp.sqrt(jnp.maximum(image, 0.0)) if gamma else image


# --- adaptive sampling --------------------------------------------------------

#: minimum samples before a pixel may be declared converged, the default
#: samples per adaptive chunk, and the absolute luminance floor added to
#: the relative tolerance (so near-black pixels don't demand absurd
#: precision)
ADAPTIVE_MIN_N = 64
ADAPTIVE_AUTO_CHUNK = 16
ADAPTIVE_ABS_FLOOR = 0.02
#: two-sided 97.5% Student-t quantiles indexed by CHUNK count n_c
#: (dof = n_c - 1); n_c < 3 can't form a CI (inf), n_c > 16 clamps to the
#: last entry (conservative)
_T975_BY_CHUNKS = np.asarray(
    [np.inf, np.inf, np.inf, 4.303, 3.182, 2.776, 2.571, 2.447,
     2.365, 2.306, 2.262, 2.228, 2.201, 2.179, 2.160, 2.145, 2.131],
    np.float32,
)


def adaptive_schedule(spp: int, chunk: int):
    """Chunk sizes of an adaptive render: a first chunk of
    ``spp - (n-1)·chunk`` samples (in [chunk, 2·chunk)) then n-1 equal
    chunks, the convergence decision running before each of them. None
    when fewer than two chunks fit (the render then runs fixed-spp)."""
    n = spp // chunk
    if n < 2:
        return None
    return [spp - (n - 1) * chunk] + [chunk] * (n - 1)


def _converged(acc, tol: float, chunk_stats=None):
    """Per-pixel stop rule over acc planes [r, g, b, n, Σlum, Σlum²].

    Converged: n >= ADAPTIVE_MIN_N and the 95% CI half-width of mean
    luminance is within tol·(mean + ADAPTIVE_ABS_FLOOR). The CI is the
    MINIMUM of the per-sample estimator (exact for independent draws) and,
    when ``chunk_stats`` ([n_c, Σm, Σm²], m = one full chunk's mean
    luminance) holds n_c >= 3 chunks, a Student-t CI on the between-chunk
    variance. Only the STRATIFIED sampler passes ``chunk_stats``: its
    per-sample variance cannot see the stratification while chunk means
    do. The random sampler keeps the exact per-sample CI alone (min-ing
    two estimates of the same quantity would pick the underestimate).

    Known approximation: chunk means of one pixel share one
    Cranley-Patterson rotation, so they are dependent and the t-CI can
    undercover beyond the usual sequential-stopping bias; the realized
    error is bounded by measurement against the fixed-spp render instead.
    Pixels that never sampled (n == 0) count as converged."""
    n = acc[3]
    n_safe = jnp.maximum(n, 1.0)
    mean = acc[4] / n_safe
    var = jnp.maximum(acc[5] / n_safe - mean * mean, 0.0)
    ci = 1.96 * jnp.sqrt(var / n_safe)
    if chunk_stats is not None:
        n_c = chunk_stats[0]
        nc_safe = jnp.maximum(n_c, 1.0)
        m_mean = chunk_stats[1] / nc_safe
        s2 = jnp.maximum(
            chunk_stats[2] / nc_safe - m_mean * m_mean, 0.0
        ) * nc_safe / jnp.maximum(n_c - 1.0, 1.0)
        t = jnp.take(
            _T975_BY_CHUNKS,
            jnp.clip(n_c.astype(jnp.int32), 0, _T975_BY_CHUNKS.shape[0] - 1),
        )
        ci = jnp.where(n_c >= 3.0, jnp.minimum(ci, t * jnp.sqrt(s2 / nc_safe)),
                       ci)
    return (n == 0.0) | (
        (n >= ADAPTIVE_MIN_N) & (ci <= tol * (mean + ADAPTIVE_ABS_FLOOR))
    )


def adaptive_band(scene, uuid, dcam, seed, row_offset, *, width: int,
                  height: int, band_h: int, sizes, opts: TraceOptions,
                  g_full: int, block: int = DEFAULT_BLOCK):
    """Adaptive render of one band: a first fixed chunk, then a lax.scan
    over equal chunks, each launched with a per-pixel budget plane (0 for
    converged pixels, the chunk size otherwise) decided in jnp from the
    accumulated statistics. Pixels keep their place in the grid; a
    converged pixel's lane is simply never alive.

    Returns (acc (6, P) planes [r, g, b, n, Σlum, Σlum²], seg pair)."""
    n_pix = width * band_h
    cs = sizes[1]
    tol = opts.adaptive_tolerance
    launch = functools.partial(
        trace_band, scene, uuid, dcam, None, seed, row_offset=row_offset,
        width=width, height=height, band_h=band_h, opts=opts, g_full=g_full,
        block=block,
    )
    sums, stats, segs = launch(
        0, spp=sizes[0], budget=jnp.full((n_pix,), sizes[0], jnp.int32)
    )
    acc = jnp.concatenate([sums, stats])
    track_chunks = opts.sampler == "stratified"

    def body(carry, j):
        acc, seg, cstats = carry
        budget = jnp.where(_converged(acc, tol, cstats), 0, cs)
        sums, stats, segs = launch(sizes[0] + j * cs, spp=cs,
                                   budget=budget.astype(jnp.int32))
        new = jnp.concatenate([sums, stats])
        if track_chunks:
            sampled = (new[3] > 0.0).astype(jnp.float32)
            m_c = new[4] / jnp.maximum(new[3], 1.0)
            cstats = cstats + jnp.stack(
                [sampled, m_c * sampled, m_c * m_c * sampled]
            )
        return (acc + new, seg + _seg_pair(segs), cstats), None

    cstats0 = jnp.zeros((3, n_pix), jnp.float32) if track_chunks else None
    (acc, seg, _), _ = jax.lax.scan(
        body, (acc, _seg_pair(segs), cstats0),
        jnp.arange(len(sizes) - 1, dtype=jnp.int32),
    )
    return acc, seg


def _finalize_adaptive(acc, width: int, band_h: int, gamma: bool):
    """Per-pixel mean from (rgb sums, n). Returns (image, mean effective
    spp, (band_h, W) per-pixel sample-count map)."""
    n = jnp.maximum(acc[3], 1.0)
    image = _gamma(_band_image(acc[:3] / n, width, band_h), gamma)
    n_img = acc[3].reshape(band_h, width)
    return image, jnp.mean(n_img), n_img


# --- entry points -------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "opts", "g_full", "block"),
)
def _render_fixed(scene, uuid, dcam, debug, key, sample_offset, *,
                  width: int, height: int, spp: int, opts: TraceOptions,
                  g_full: int, block: int):
    sums, _, segs = trace_band(
        scene, uuid, dcam, debug, _seed_from_key(key), sample_offset, 0,
        width=width, height=height, band_h=height, spp=spp, opts=opts,
        g_full=g_full, block=block,
    )
    image = _band_image(sums[:3], width, height) * (1.0 / spp)
    return _gamma(image, opts.gamma), _seg_pair(segs)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "sizes", "opts", "g_full", "block"),
)
def _render_adaptive(scene, uuid, dcam, key, *, width: int, height: int,
                     sizes, opts: TraceOptions, g_full: int, block: int):
    acc, seg = adaptive_band(
        scene, uuid, dcam, _seed_from_key(key), 0, width=width,
        height=height, band_h=height, sizes=list(sizes), opts=opts,
        g_full=g_full, block=block,
    )
    return _finalize_adaptive(acc, width, height, opts.gamma) + (seg,)


def render_image_pallas(
    scene: Scene,
    dcam: DerivedCamera,
    width: int,
    height: int,
    spp: int,
    key,
    opts: TraceOptions,
    debug=None,
    return_stats: bool = False,
    sample_offset=0,
    static_split=None,
    block: int = DEFAULT_BLOCK,
):
    """Render through the kernel: one launch for a fixed-spp render, one
    per chunk (inside one device program) for an adaptive one.

    ``sample_offset`` (static int or traced i32) shifts every sample's
    absolute index — the stratified progressive step passes frame·spp so
    an accumulation session decomposes exactly like one offline render.
    ``static_split``: a ``_containable_split`` result the caller computed
    on concrete hints (the progressive factories, whose scene is traced
    here). Returns (H, W, 3), row 0 at the image bottom; with
    ``return_stats`` also {'segments'} (+ 'mean_spp', 'spp_map' when
    adaptive)."""
    if opts.enable_debug and debug is None:
        from raytracer_tpu.render.options import DebugParams

        debug = DebugParams.none()
    split = (static_split if static_split is not None
             else _containable_split(scene, dcam, opts))
    scene, uuid, g_full = _apply_split(scene, split)
    sizes = None
    if opts.adaptive_tolerance > 0.0:
        if not (isinstance(sample_offset, int) and sample_offset == 0):
            # pixels stop at DIFFERENT sample counts, so a uniform base
            # offset cannot describe where a later render would resume
            raise ValueError(
                "adaptive_tolerance requires sample_offset == 0 "
                "(per-pixel stop counts cannot resume from a uniform base)"
            )
        sizes = adaptive_schedule(
            spp, opts.adaptive_chunk_spp or ADAPTIVE_AUTO_CHUNK
        )
        if sizes is None or opts.enable_debug:
            import dataclasses

            opts = dataclasses.replace(opts, adaptive_tolerance=0.0)
    if opts.adaptive_tolerance > 0.0:
        image, mean_spp, spp_map, seg = _render_adaptive(
            scene, uuid, dcam, key, width=width, height=height,
            sizes=tuple(sizes), opts=opts, g_full=g_full, block=block,
        )
        if return_stats:
            return image, {"segments": _seg_value(seg), "mean_spp": mean_spp,
                           "spp_map": spp_map}
        return image
    image, seg = _render_fixed(
        scene, uuid, dcam, debug if opts.enable_debug else None, key,
        sample_offset, width=width, height=height, spp=spp, opts=opts,
        g_full=g_full, block=block,
    )
    if return_stats:
        return image, {"segments": _seg_value(seg)}
    return image
