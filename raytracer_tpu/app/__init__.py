"""Application layer: image I/O, the interactive engine, and the CLI renderer.

The analog of the reference's host shell — the rAF frame loop
(src/lib.rs:61-107), DOM input plumbing (src/dom.rs), and canvas PNG export
(src/dom.rs:126-143) — without a browser: a headless engine driven by a
clock + input events, and PNG export through the native C++ runtime.
"""
