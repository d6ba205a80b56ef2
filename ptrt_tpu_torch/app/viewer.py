"""Interactive windowed viewer + frame loop — the counterpart of
``ptrt_tpu/app/viewer.py``.

The reference's GLFW/CUDA interop viewer (``glfw_view_interop.hpp:43-332``)
blits a PBO without a copy.  Here the frame program leaves a uint8 image on
the card; ``run_interactive`` copies it to pinned host memory without
blocking (the one device-to-host copy a frame), enqueues the next frame,
and only then waits for the copy and presents it.  Two presentation
backends:

* ``PygameViewer`` — a real window when a display exists (F11 fullscreen,
  mouse-look with capture toggle, ESC quits), mirroring the reference's
  GLFW window behavior.
* ``HttpViewer`` — headless browser viewer: an MJPEG stream plus key events
  POSTed from a tiny HTML page.  Works over SSH/dev tunnels where the
  reference's GLFW window cannot.

pygame and PIL are imported only when a viewer needs them.
``run_interactive`` is the game ``main()`` frame loop: poll input ->
CameraController + VisualizationController -> render -> present
(``glfw_view_interop.hpp`` loop + ``app_utils.cuh:211-368`` controllers).
"""

from __future__ import annotations

import io
import threading
import time

import numpy as np

from ptrt_tpu_torch.app.app_utils import CameraController, InputState
from ptrt_tpu_torch.app.viz_controller import VisualizationController


class PygameViewer:
    """Windowed presentation via pygame/SDL (needs a display; use
    ``SDL_VIDEODRIVER=dummy`` only for tests)."""

    def __init__(self, width: int, height: int,
                 title: str = "ptrt_tpu_torch"):
        import pygame

        self._pg = pygame
        pygame.init()
        self.width, self.height = width, height
        self._fullscreen = False
        self.screen = pygame.display.set_mode((width, height))
        pygame.display.set_caption(title)
        self._grab = True
        self._set_grab(True)
        self.closed = False

    def _set_grab(self, grab: bool) -> None:
        try:
            self._pg.event.set_grab(grab)
            self._pg.mouse.set_visible(not grab)
        except Exception:
            pass

    def poll(self) -> InputState | None:
        """Drain events -> InputState; None means quit requested."""
        pg = self._pg
        inp = InputState()
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                return None
            if ev.type == pg.KEYDOWN and ev.key == pg.K_ESCAPE:
                return None
            if ev.type == pg.KEYDOWN and ev.key == pg.K_F11:
                # F11 fullscreen toggle (glfw_view_interop.hpp:120-147)
                self._fullscreen = not self._fullscreen
                flags = pg.FULLSCREEN if self._fullscreen else 0
                self.screen = pg.display.set_mode(
                    (self.width, self.height), flags)
            if ev.type == pg.MOUSEMOTION:
                inp.mouse_dx += ev.rel[0]
                inp.mouse_dy -= ev.rel[1]  # invert: up = positive
        keymap = {
            pg.K_w: "w", pg.K_a: "a", pg.K_s: "s", pg.K_d: "d",
            pg.K_SPACE: "space", pg.K_LCTRL: "ctrl", pg.K_RCTRL: "ctrl",
            pg.K_LSHIFT: "shift", pg.K_RSHIFT: "shift", pg.K_c: "c",
            pg.K_f: "f", pg.K_v: "v", pg.K_p: "p", pg.K_h: "h",
            pg.K_PLUS: "+", pg.K_EQUALS: "=", pg.K_MINUS: "-",
        }
        pressed = pg.key.get_pressed()
        for k, name in keymap.items():
            if pressed[k]:
                inp.keys.add(name)
        return inp

    def present(self, rgb8: np.ndarray) -> None:
        pg = self._pg
        h, w, _ = rgb8.shape
        surf = pg.surfarray.make_surface(np.swapaxes(rgb8, 0, 1))
        if (w, h) != (self.width, self.height):
            surf = pg.transform.smoothscale(surf, (self.width, self.height))
        self.screen.blit(surf, (0, 0))
        pg.display.flip()

    def close(self) -> None:
        if not self.closed:
            self._pg.quit()
            self.closed = True


class HttpViewer:
    """Headless MJPEG viewer: open http://localhost:<port>/ in a browser.

    The page streams ``/stream`` (multipart JPEG) and POSTs keydown/keyup/
    mousemove to ``/input``; ``poll`` drains them into an InputState.
    """

    _PAGE = """<!doctype html><html><head><title>ptrt_tpu viewer</title>
<style>body{margin:0;background:#111;display:flex;align-items:center;
justify-content:center;height:100vh}img{image-rendering:pixelated;
max-width:100vw;max-height:100vh}</style></head>
<body><img id="v" src="/stream"><script>
const keys=new Set();let mdx=0,mdy=0,locked=false;
const map={w:'w',a:'a',s:'s',d:'d',' ':'space',Shift:'shift',Control:'ctrl',
c:'c',f:'f',v:'v',p:'p',h:'h','+':'+','=':'=','-':'-'};
function send(){fetch('/input',{method:'POST',body:JSON.stringify(
{keys:[...keys],dx:mdx,dy:mdy})});mdx=0;mdy=0;}
addEventListener('keydown',e=>{const k=map[e.key]||map[e.key.toLowerCase()];
if(k){keys.add(k);send();}});
addEventListener('keyup',e=>{const k=map[e.key]||map[e.key.toLowerCase()];
if(k){keys.delete(k);send();}});
document.getElementById('v').onclick=e=>{e.target.requestPointerLock();};
addEventListener('pointerlockchange',()=>{locked=!!document.pointerLockElement});
addEventListener('mousemove',e=>{if(locked){mdx+=e.movementX;mdy-=e.movementY;}});
setInterval(send,50);
</script></body></html>"""

    def __init__(self, width: int, height: int, port: int = 8734,
                 host: str = "127.0.0.1"):
        # localhost-only by default: the frame stream and the /input
        # injection endpoint should not be reachable from the network
        # unless explicitly opted in (dev tunnels forward localhost fine)
        import http.server

        self.port = port
        self.host = host
        self.closed = False
        self._frame_jpeg = b""
        self._frame_event = threading.Condition()
        self._keys: set = set()
        self._dx = 0.0
        self._dy = 0.0
        self._lock = threading.Lock()
        viewer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = viewer._PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=f")
                    self.end_headers()
                    try:
                        while not viewer.closed:
                            with viewer._frame_event:
                                viewer._frame_event.wait(timeout=1.0)
                                jpg = viewer._frame_jpeg
                            if not jpg:
                                continue
                            self.wfile.write(
                                b"--f\r\nContent-Type: image/jpeg\r\n"
                                b"Content-Length: %d\r\n\r\n" % len(jpg))
                            self.wfile.write(jpg)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                elif self.path == "/frame.jpg":
                    jpg = viewer._frame_jpeg
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.send_header("Content-Length", str(len(jpg)))
                    self.end_headers()
                    self.wfile.write(jpg)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                import json

                n = int(self.headers.get("Content-Length", 0))
                try:
                    data = json.loads(self.rfile.read(n) or b"{}")
                except Exception:
                    data = {}
                with viewer._lock:
                    viewer._keys = set(data.get("keys", []))
                    viewer._dx += float(data.get("dx", 0.0))
                    viewer._dy += float(data.get("dy", 0.0))
                self.send_response(204)
                self.end_headers()

        self._server = http.server.ThreadingHTTPServer((self.host, port),
                                                       Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        print(f"HttpViewer: open http://localhost:{port}/ "
              "(click image for mouse-look)")

    def poll(self) -> InputState | None:
        inp = InputState()
        with self._lock:
            inp.keys = set(self._keys)
            inp.mouse_dx, self._dx = self._dx, 0.0
            inp.mouse_dy, self._dy = self._dy, 0.0
        return inp

    def present(self, rgb8: np.ndarray) -> None:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb8).save(buf, format="JPEG", quality=85)
        with self._frame_event:
            self._frame_jpeg = buf.getvalue()
            self._frame_event.notify_all()

    def close(self) -> None:
        self.closed = True
        self._server.shutdown()


def make_viewer(width: int, height: int, prefer: str = "auto",
                port: int = 8734):
    """Pick a presentation backend: pygame window if a display exists,
    otherwise the HTTP viewer."""
    import os

    if prefer == "http":
        return HttpViewer(width, height, port)
    if prefer == "pygame" or os.environ.get("DISPLAY") or \
            os.environ.get("SDL_VIDEODRIVER"):
        try:
            return PygameViewer(width, height)
        except Exception as e:
            if prefer == "pygame":
                raise
            print(f"pygame viewer unavailable ({e}); using HTTP viewer")
    return HttpViewer(width, height, port)


class _HostFrames:
    """The frame's one device-to-host copy: a non-blocking copy of the
    card's uint8 image into one of two pinned host buffers (used in turn),
    an event recorded after it.  A CPU image is its own host copy."""

    def __init__(self):
        self._bufs = [None, None]
        self._turn = 0

    def start(self, img):
        """Begin the copy of ``img``; returns what ``finish`` takes."""
        if img.device.type != "cuda":
            return img, None
        import torch

        k, self._turn = self._turn, 1 - self._turn
        buf = self._bufs[k]
        if buf is None or buf.shape != img.shape:
            buf = self._bufs[k] = torch.empty(img.shape, dtype=img.dtype,
                                              pin_memory=True)
        buf.copy_(img, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return buf, done

    @staticmethod
    def finish(started) -> np.ndarray:
        """Wait for the copy; the host image (a view of the pinned buffer,
        written again two frames later)."""
        buf, done = started
        if done is not None:
            done.synchronize()
        return buf.numpy()


def run_interactive(scene, viewer=None, max_frames: int | None = None,
                    on_frame=None, prefer: str = "auto") -> int:
    """The interactive game loop (``glfw_view_interop.hpp`` +
    ``app_utils.cuh`` controllers).  ``on_frame(scene, frame_idx, dt)`` is
    the game-step hook.  Returns frames presented.

    Present is ASYNCHRONOUS with respect to the next frame's device work:
    the next frame is enqueued before the previous frame's host copy is
    waited for and handed to the presentation backend (a double buffer of
    pinned host memory).  ``viewer.present`` gets a view of that buffer; a
    viewer that keeps frames copies them.
    """
    viewer = viewer or make_viewer(scene.width, scene.height, prefer)
    cam_ctl = CameraController()
    cam_ctl.init_from_scene(scene)
    viz_ctl = VisualizationController(scene)
    host = _HostFrames()

    frames = 0
    pending = None  # the last frame's host copy in flight
    t_prev = time.time()
    try:
        while max_frames is None or frames < max_frames:
            inp = viewer.poll()
            if inp is None:
                break
            now = time.time()
            dt, t_prev = now - t_prev, now
            if inp.keys or inp.mouse_dx or inp.mouse_dy:
                cam_ctl.update(scene, inp, dt)
                viz_ctl.handle_keys(inp.keys)
            if on_frame is not None:
                on_frame(scene, frames, dt)
            started = host.start(scene.render_frame_device())
            if pending is not None:
                viewer.present(host.finish(pending))
            pending = started  # present next iteration (double buffer)
            frames += 1
        if pending is not None:
            viewer.present(host.finish(pending))
    finally:
        viewer.close()
    return frames
