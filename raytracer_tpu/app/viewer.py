"""Interactive terminal viewer: the reference's browser UX without a browser.

Maps the reference's controls (src/dom.rs:160-273) onto a raw-mode
terminal, rendering the progressive accumulation buffer as ANSI truecolor
half-block characters (two pixels per character cell):

    w/a/s/d     fly (src/state.rs:411-441)         i/j/k/l   look (mouse-look analog)
    e/c         up/down (space/shift analog)       arrows    look (same steps)
    p / Esc     pause/resume (Escape analog)       +/-       fov zoom (wheel analog)
    r           reset scene ("Reset")              x         save PNG ("Save Image")
    g           toggle debug overlay               q         quit

Continuous mouse input (the pointer-lock analog, src/dom.rs:105-114,
160-273): on a tty the viewer enables xterm SGR mouse reporting
(``CSI ?1002h`` button-event tracking + ``?1006h`` SGR encoding — spoken
by xterm, kitty, ghostty, wezterm, iTerm2, tmux…), so **dragging with
the left button looks around continuously** through the exact
``Engine.handle_mouse_move`` path the reference's pointer-lock handler
feeds, and the **scroll wheel zooms fov** like the browser wheel
(src/dom.rs:34-40). Terminals without mouse support keep the discrete
i/j/k/l / arrow-key fallback (``LOOK_STEP`` "pixels" per press).

Full-resolution display (``--display kitty``): frames are transmitted
pixel-perfect via the kitty graphics protocol (app/display.py) instead
of downsampled ANSI half-blocks — the analog of the reference blitting
the whole canvas every frame (src/dom.rs:277-291).

One deliberate divergence from the browser remains (a raw-terminal
constraint, not an omission — see src/dom.rs:48-103):

* **Held keys.** The reference gets keydown/keyup pairs and moves while
  a key is down. Raw terminals deliver only key *repeats*, so each
  movement keypress arms a 200 ms hold window (``KEY_HOLD_MS``) that the
  OS repeat rate (typically 30–60 ms once repeating) keeps refreshed —
  holding a key moves continuously, releasing stops within 200 ms.

The frame loop is exactly the Engine tick (trace 1 spp → accumulate →
display), i.e. the rAF loop of src/lib.rs:61-107 driven by a terminal clock.
"""

from __future__ import annotations

import select
import sys
import time

import numpy as np

from raytracer_tpu.app.engine import Engine
from raytracer_tpu.scene import presets


def frame_to_ansi(img: np.ndarray, max_cols: int = 100) -> str:
    """f32 (H, W, 3) GL-row-order framebuffer → ANSI half-block string.

    Each character cell shows two vertically stacked pixels (▀ with fg =
    upper pixel, bg = lower pixel). Downsamples by striding to fit
    ``max_cols``. Encoded by the native C++ runtime when available (this
    is the per-frame host hot path — the analog of the reference's canvas
    blit); the pure-Python fallback below is byte-identical (pinned by
    tests/test_viewer.py).
    """
    h, w, _ = img.shape
    stride = max(1, (w + max_cols - 1) // max_cols)
    from raytracer_tpu.native import ansi_halfblocks_native

    native = ansi_halfblocks_native(img, stride)
    if native is not None:
        return native
    sub = img[::-1][::stride, ::stride]  # flip to scanline order + downsample
    if sub.shape[0] % 2:
        sub = sub[:-1]
    u8 = np.clip(sub * 255.0 + 0.5, 0, 255).astype(np.uint8)
    top = u8[0::2]
    bot = u8[1::2]
    lines = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


class _RawTerminal:
    """Raw-mode stdin for non-blocking single-key reads.

    Degrades to a keyless no-op when stdin is not a tty (piped/CI
    ``--max-frames`` runs) instead of dying on the termios ioctl."""

    def __enter__(self):
        self.enabled = sys.stdin.isatty()
        if self.enabled:
            import termios
            import tty

            self.fd = sys.stdin.fileno()
            self.saved = termios.tcgetattr(self.fd)
            tty.setcbreak(self.fd)
        return self

    def __exit__(self, *exc):
        if self.enabled:
            import termios

            termios.tcsetattr(self.fd, termios.TCSADRAIN, self.saved)

    def read_keys(self):
        if not self.enabled:
            return []
        keys = []
        while select.select([sys.stdin], [], [], 0)[0]:
            keys.append(sys.stdin.read(1))
        return keys


#: key → engine action (held-key semantics approximated by a decay window)
MOVE_KEYS = {"w": "w", "a": "a", "s": "s", "d": "d", "e": "space", "c": "shift"}
LOOK_STEP = 15.0  # "mouse" movement units per keypress
#: keydown→keyup approximation: each movement keypress holds the key this
#: long; OS key-repeat refreshes the window while physically held
KEY_HOLD_MS = 200.0

#: terminal arrow keys arrive as CSI (\x1b[A..D) or SS3 (\x1bOA..OD)
#: escape sequences depending on the terminal's cursor-key mode
_ARROW_SEQS = {
    "[A": "up", "[B": "down", "[C": "right", "[D": "left",
    "OA": "up", "OB": "down", "OC": "right", "OD": "left",
}
_LOOK_TOKENS = {  # token → (dx, dy) mouse-move analog
    "i": (0.0, -LOOK_STEP), "up": (0.0, -LOOK_STEP),
    "k": (0.0, +LOOK_STEP), "down": (0.0, +LOOK_STEP),
    "j": (-LOOK_STEP, 0.0), "left": (-LOOK_STEP, 0.0),
    "l": (+LOOK_STEP, 0.0), "right": (+LOOK_STEP, 0.0),
}

#: longest plausible SGR mouse report (ESC [ < btn ; col ; row M); a
#: longer unterminated "[<..." run is malformed input, not a split read
_SGR_MAX = 24

#: SGR button codes 64/65 = wheel up/down → fov zoom (src/dom.rs:34-40)
MOUSE_WHEEL_UP, MOUSE_WHEEL_DOWN = 64, 65


def parse_keys(chars: list[str], pending: str = ""):
    """Raw char stream → key tokens, decoding arrow and SGR mouse
    escape sequences.

    Returns ``(tokens, pending)``: ``pending`` carries an incomplete
    trailing escape sequence into the next drain (sequences can split
    across reads). A lone ESC (the Escape key, src/dom.rs:62-65) stays
    pending until the caller sees a drain with no new input and flushes
    it — that's how terminals disambiguate Esc from Esc-prefixed keys.

    Key tokens are strings; mouse reports (``CSI < Cb;Cx;Cy M|m``,
    xterm SGR 1006 mode) become ``("mouse", Cb, Cx, Cy, is_release)``
    tuples for the caller's drag/wheel handling.
    """
    buf = pending + "".join(chars)
    tokens: list = []
    i = 0
    while i < len(buf):
        c = buf[i]
        if c == "\x1b":
            if buf[i + 1:i + 3] == "[<":
                # SGR mouse report: scan for the M/m terminator
                end = i + 3
                while end < len(buf) and buf[end] not in "Mm":
                    end += 1
                if end >= len(buf):
                    if end - i <= _SGR_MAX:
                        return tokens, buf[i:]  # split across reads — hold
                    i = end  # unterminated flood: drop, don't wedge
                    continue
                try:
                    cb, cx, cy = (int(p) for p in buf[i + 3:end].split(";"))
                    tokens.append(("mouse", cb, cx, cy, buf[end] == "m"))
                except ValueError:
                    pass  # malformed report — drop it
                i = end + 1
                continue
            seq = buf[i + 1:i + 3]
            if len(seq) < 2 and (not seq or seq in ("[", "O")):
                return tokens, buf[i:]  # maybe incomplete — hold it
            if seq in _ARROW_SEQS:
                tokens.append(_ARROW_SEQS[seq])
                i += 3
                continue
            tokens.append("escape")  # ESC followed by a non-arrow key
            i += 1
            continue
        tokens.append(c)
        i += 1
    return tokens, ""


class MouseLook:
    """Left-button drag → continuous look deltas (the pointer-lock analog).

    The reference feeds raw ``movementX/movementY`` pixel deltas to the
    look handler (src/dom.rs:105-114); a terminal reports positions in
    character cells, so deltas are scaled by the cell's size in render
    pixels (``cell_px``; half-block cells are two pixels tall, hence the
    2× vertical factor) before entering the same handler."""

    def __init__(self, cell_px: float):
        self.cell_px = max(1.0, float(cell_px))
        self._last: tuple[int, int] | None = None

    def feed(self, cb: int, x: int, y: int, release: bool):
        """One SGR report → ``(dx, dy)`` look delta or None."""
        if cb >= 64:  # wheel — the caller routes it to fov zoom
            return None
        btn, motion = cb & 3, bool(cb & 32)
        if release:
            self._last = None
            return None
        if motion:
            if self._last is None:
                return None
            dx = (x - self._last[0]) * self.cell_px
            dy = (y - self._last[1]) * self.cell_px * 2.0
            self._last = (x, y)
            return (dx, dy) if (dx or dy) else None
        if btn == 0:  # left press arms the drag
            self._last = (x, y)
        return None


def run_viewer(
    config: str = "demo",
    width: int = 320,
    height: int = 180,
    backend: str = "auto",
    max_frames: int | None = None,
    target_fps: float = 30.0,
    cols: int = 100,
    sampler: str = "random",
    display: str = "ansi",
):
    scene, cam, *_ = presets.get_config(config, width, height)
    engine = Engine(scene, cam, width, height, spp=1, max_depth=8,
                    backend=backend, sampler=sampler)
    engine.set_paused(False)

    held: dict = {}
    pending = ""
    frame = 0
    mouse = MouseLook(width / max(1, cols))
    out = sys.stdout
    with _RawTerminal() as term:
        out.write("\x1b[2J")  # clear
        if term.enabled:
            # SGR mouse reporting: button-event tracking (press/release/
            # drag motion + wheel) in unambiguous 1006 encoding
            out.write("\x1b[?1002h\x1b[?1006h")
        try:
            while max_frames is None or frame < max_frames:
                now = time.monotonic() * 1000.0
                raw = term.read_keys()
                tokens, pending = parse_keys(raw, pending)
                if not raw and pending == "\x1b":
                    # a whole frame passed with nothing after ESC: it was
                    # the Escape key itself, not a sequence prefix
                    tokens.append("escape")
                    pending = ""
                for k in tokens:
                    if isinstance(k, tuple):  # ("mouse", cb, x, y, release)
                        _, cb, mx, my, rel = k
                        if cb == MOUSE_WHEEL_UP and not rel:
                            engine.handle_wheel(-1.0)
                        elif cb == MOUSE_WHEEL_DOWN and not rel:
                            engine.handle_wheel(+1.0)
                        else:
                            d = mouse.feed(cb, mx, my, rel)
                            if d:
                                engine.handle_mouse_move(*d)
                        continue
                    if k == "q":
                        return frame
                    elif k == "p":
                        engine.set_paused(not engine.app.is_paused)
                    elif k == "escape":
                        # Escape pauses, never resumes (src/dom.rs:62-65)
                        engine.handle_key("escape", True)
                    elif k == "r":
                        engine.reset()
                    elif k == "x":
                        # render-before-save + paused 25-spp floor
                        # (src/dom.rs:115-124, src/webgl.rs:342-347)
                        engine.request_save(f"viewer_{frame}.png")
                    elif k == "g":
                        # debug visualization toggle (cursor marker +
                        # selection outline — runs IN the Pallas kernel;
                        # restarts accumulation so the overlay shows/clears
                        # immediately)
                        engine.set_debugging(not engine.app.enable_debugging)
                    elif k == "+":
                        engine.handle_wheel(-1.0)
                    elif k == "-":
                        engine.handle_wheel(+1.0)
                    elif k in _LOOK_TOKENS:
                        engine.handle_mouse_move(*_LOOK_TOKENS[k])
                    elif k in MOVE_KEYS:
                        held[MOVE_KEYS[k]] = now + KEY_HOLD_MS

                for name, until in list(held.items()):
                    engine.handle_key(name, now < until)
                    if now >= until:
                        del held[name]

                engine.tick(now)
                frame += 1

                fps = engine.app.average_fps(now)
                out.write("\x1b[H")  # home
                if display == "kitty":
                    from raytracer_tpu.app.display import kitty_frame

                    out.write(kitty_frame(engine.framebuffer()))
                else:
                    out.write(frame_to_ansi(engine.framebuffer(), cols))
                status = (
                    f"\n[{config}] frame {frame} "
                    f"acc {int(engine.render_state.render_count)} "
                )
                if fps is not None:
                    status += f"{fps:5.1f} fps "
                status += (
                    "(wasd/ec move, drag/ijkl/arrows look, wheel/+/- zoom, "
                    "p pause, g debug, x save, q quit)"
                )
                out.write(status + "\x1b[K")
                out.flush()

                dt = time.monotonic() * 1000.0 - now
                sleep_ms = 1000.0 / target_fps - dt
                if sleep_ms > 0:
                    time.sleep(sleep_ms / 1000.0)
        finally:
            if term.enabled:
                out.write("\x1b[?1002l\x1b[?1006l")
            out.write("\x1b[0m\n")
            out.flush()
    return frame


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="interactive terminal path tracer")
    p.add_argument("--config", default="demo", choices=sorted(presets.BASELINE_CONFIGS))
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=180)
    p.add_argument(
        "--backend", default="auto", choices=["auto", "jnp", "pallas"]
    )
    p.add_argument("--cols", type=int, default=100)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument(
        "--sampler", default="random", choices=("random", "stratified"),
        help="camera-sample sequencer (stratified = per-pixel "
        "low-discrepancy accumulation across frames)",
    )
    p.add_argument(
        "--display", default="ansi", choices=("ansi", "kitty"),
        help="frame encoding: ansi half-blocks (any terminal, "
        "downsampled to --cols) or the kitty graphics protocol "
        "(full-resolution pixels; kitty/ghostty/wezterm)",
    )
    a = p.parse_args()
    from raytracer_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    run_viewer(a.config, a.width, a.height, a.backend, a.max_frames,
               cols=a.cols, sampler=a.sampler,
               display=a.display)
