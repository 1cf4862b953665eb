"""Terminal viewer tests (the renderable part; raw-terminal loop excluded)."""

import numpy as np
import pytest

from raytracer_tpu.app.viewer import frame_to_ansi


def test_frame_to_ansi_shape_and_colors():
    img = np.zeros((8, 16, 3), np.float32)
    img[:, :, 0] = 1.0  # all red
    s = frame_to_ansi(img, max_cols=16)
    lines = s.split("\n")
    assert len(lines) == 4  # 8 rows → 4 half-block lines
    assert "38;2;255;0;0" in s  # red foreground
    assert s.endswith("\x1b[0m")


def test_frame_to_ansi_downsamples():
    img = np.random.default_rng(0).random((32, 200, 3)).astype(np.float32)
    s = frame_to_ansi(img, max_cols=50)
    first = s.split("\n")[0]
    assert first.count("▀") == 50


def test_frame_to_ansi_flips_to_scanline():
    img = np.zeros((4, 4, 3), np.float32)
    img[-1, :, 2] = 1.0  # GL top row blue
    s = frame_to_ansi(img, max_cols=4)
    # the blue row must appear in the FIRST output line (top of terminal)
    assert "38;2;0;0;255" in s.split("\n")[0]


def test_viewer_loop_pty_smoke():
    """Drive the raw-terminal event loop end-to-end in a child process under
    a pty: look/move/zoom/pause/reset keys are consumed, frames render as
    ANSI, and 'q' (or the frame cap) exits cleanly, restoring the tty."""
    import os
    import pty
    import subprocess
    import sys
    import time

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "from raytracer_tpu.app.viewer import run_viewer; "
        "n = run_viewer('two_sphere', 64, 36, max_frames=60, "
        "target_fps=1000.0, cols=24); "
        "print('VIEWER_DONE', n)"
    )
    master, slave = pty.openpty()
    proc = subprocess.Popen(
        [sys.executable, "-c", code],
        stdin=slave,
        stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL,
        env=env,
        cwd=repo,
    )
    os.close(slave)
    try:
        # exercise every control family while the loop runs (the first
        # frames include the jit compile, so space the keys out); the
        # mouse bytes are an SGR press→drag→release→wheel sequence
        for key in [b"i", b"j", b"w", b"+", b"p", b"p", b"r",
                    b"\x1b[<0;10;5M", b"\x1b[<32;12;6M",
                    b"\x1b[<0;12;6m", b"\x1b[<64;5;5M"]:
            os.write(master, key)
            time.sleep(0.3)
        os.write(master, b"q")
        out, _ = proc.communicate(timeout=180)
    finally:
        os.close(master)
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-500:]
    assert b"VIEWER_DONE" in out
    assert b"\x1b[38;2;" in out  # truecolor half-block frames were drawn
    assert b"fps" in out or b"frame" in out


def test_native_ansi_matches_python():
    """The C++ ANSI encoder is byte-identical to the Python fallback on
    random framebuffers across strides and odd shapes."""
    from raytracer_tpu import native
    from raytracer_tpu.app import viewer

    if native.LIB is None:
        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(7)
    for h, w, cols in [(36, 64, 24), (45, 100, 100), (17, 33, 10), (8, 128, 64)]:
        img = rng.random((h, w, 3), dtype=np.float32) * 1.4 - 0.2  # out-of-gamut too
        stride = max(1, (w + cols - 1) // cols)
        got = native.ansi_halfblocks_native(img, stride)
        # force the Python path by simulating a missing library
        orig = native.LIB
        try:
            native.LIB = None
            want = viewer.frame_to_ansi(img, cols)
        finally:
            native.LIB = orig
        assert got == want, (h, w, cols)


def test_parse_keys_plain_chars_pass_through():
    from raytracer_tpu.app.viewer import parse_keys

    tokens, pending = parse_keys(list("wasd+x"))
    assert tokens == ["w", "a", "s", "d", "+", "x"]
    assert pending == ""


def test_parse_keys_decodes_arrow_sequences():
    from raytracer_tpu.app.viewer import parse_keys

    # CSI form (normal cursor-key mode) and SS3 form (application mode)
    tokens, pending = parse_keys(list("\x1b[A\x1b[Bw\x1bOC\x1b[D"))
    assert tokens == ["up", "down", "w", "right", "left"]
    assert pending == ""


def test_parse_keys_holds_split_sequence_across_drains():
    from raytracer_tpu.app.viewer import parse_keys

    # sequence split across two reads: nothing emitted early, then the
    # arrow comes out whole
    tokens, pending = parse_keys(["\x1b", "["])
    assert tokens == []
    assert pending == "\x1b["
    tokens, pending = parse_keys(["A", "w"], pending)
    assert tokens == ["up", "w"]
    assert pending == ""


def test_parse_keys_lone_escape_stays_pending_then_flushable():
    from raytracer_tpu.app.viewer import parse_keys

    tokens, pending = parse_keys(["\x1b"])
    assert tokens == []
    assert pending == "\x1b"  # run loop flushes this as Escape after a
    # frame with no further input (Esc vs Esc-prefixed disambiguation)
    tokens, pending = parse_keys(["\x1b", "q"])  # ESC then non-arrow
    assert tokens == ["escape", "q"]
    assert pending == ""


def test_parse_keys_decodes_sgr_mouse_reports():
    from raytracer_tpu.app.viewer import parse_keys

    # press (M), drag motion (btn|32, M), release (m), wheel up
    tokens, pending = parse_keys(
        list("\x1b[<0;10;5M\x1b[<32;12;6Mw\x1b[<0;12;6m\x1b[<64;3;3M")
    )
    assert tokens == [
        ("mouse", 0, 10, 5, False),
        ("mouse", 32, 12, 6, False),
        "w",
        ("mouse", 0, 12, 6, True),
        ("mouse", 64, 3, 3, False),
    ]
    assert pending == ""


def test_parse_keys_holds_split_mouse_report():
    from raytracer_tpu.app.viewer import parse_keys

    tokens, pending = parse_keys(list("\x1b[<32;1"))
    assert tokens == []
    assert pending == "\x1b[<32;1"
    tokens, pending = parse_keys(list("40;22Mq"), pending)
    assert tokens == [("mouse", 32, 140, 22, False), "q"]
    assert pending == ""


def test_parse_keys_drops_malformed_and_flooding_sgr():
    from raytracer_tpu.app.viewer import parse_keys

    # malformed body (non-integer fields) terminates but emits nothing
    tokens, pending = parse_keys(list("\x1b[<a;b;cMw"))
    assert tokens == ["w"]
    assert pending == ""
    # an unterminated over-long "[<" run is dropped, not held forever
    tokens, pending = parse_keys(list("\x1b[<" + "9" * 40))
    assert tokens == []
    assert pending == ""


def test_mouse_look_drag_semantics():
    from raytracer_tpu.app.viewer import MouseLook

    m = MouseLook(cell_px=4.0)
    # motion before any press: no delta (drag not armed)
    assert m.feed(32, 5, 5, False) is None
    # press arms, first motion yields cell-scaled deltas (y doubled:
    # half-block cells are two pixels tall)
    assert m.feed(0, 10, 5, False) is None
    assert m.feed(32, 12, 6, False) == (8.0, 8.0)
    assert m.feed(32, 11, 6, False) == (-4.0, 0.0)
    # release disarms; further motion is ignored until the next press
    assert m.feed(0, 11, 6, True) is None
    assert m.feed(32, 20, 9, False) is None
    # wheel codes never produce look deltas
    assert m.feed(64, 1, 1, False) is None
    assert m.feed(65, 1, 1, False) is None


def test_kitty_frame_round_trips_png():
    from raytracer_tpu.app.display import CHUNK, kitty_frame, parse_kitty_commands
    from raytracer_tpu.app.io import decode_png

    import base64

    rng = np.random.default_rng(3)
    # random data is PNG-incompressible, so this spans several 4096-byte
    # chunks and exercises the m=1/m=0 continuation framing
    img = rng.random((48, 96, 3), dtype=np.float32)
    cmds = parse_kitty_commands(kitty_frame(img, image_id=7))
    assert len(cmds) >= 4  # delete + >=3 transmit chunks
    # first command deletes the previous placement of this image id
    assert cmds[0][0] == {"a": "d", "d": "i", "i": "7", "q": "2"}
    # transmit commands: full keys on the first, m-only continuations,
    # final chunk m=0, every chunk within the protocol limit
    first_keys = cmds[1][0]
    assert first_keys["a"] == "T" and first_keys["f"] == "100"
    assert first_keys["i"] == "7" and first_keys["q"] == "2"
    for kv, chunk in cmds[1:-1]:
        assert kv["m"] == "1"
        assert len(chunk) == CHUNK
    assert cmds[-1][0]["m"] == "0"
    payload = "".join(chunk for _, chunk in cmds[1:])
    decoded = decode_png(base64.standard_b64decode(payload))
    assert decoded.shape == (48, 96, 3)
    # display orientation + quantization match the export pipeline
    from raytracer_tpu.app.io import tonemap_u8

    assert np.array_equal(decoded, tonemap_u8(img, flip_vertical=True))
