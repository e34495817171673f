"""Live rendering during stepping: the reference's GRAPHICS mode, decoupled
(a port of ``titan_tpu/runtime/live.py``).

The reference draws masses/springs from INSIDE the GPU step loop every 0.01
sim-seconds through CUDA-GL interop (sim.cu:1814-1838, 1944-2052), which
couples rendering latency into physics throughput and forces one window per
process.  Here the chunked control plane does the decoupling:
``Simulation._state`` is an immutable snapshot replaced at every chunk
boundary, so a viewer thread reads it CONCURRENTLY with stepping -- no
pause, no frame copy in the stepping loop.

On the card the viewer copies a snapshot's positions on a stream of its
own, after the event the worker recorded at the end of the chunk that made
the snapshot: a copy on the default stream would queue behind the chunk in
flight and stall the viewer for its length.  The snapshot is marked as used
by that stream (``record_stream``) so that the caching allocator does not
hand its memory to the next chunk while the copy runs.

``LiveViewer`` serves a self-contained browser page (same zero-dependency
canvas renderer as runtime/viewer.Recorder.export_html) over a local HTTP
socket; the page polls ``/frame`` for the latest positions while the
simulation runs.  Camera control: drag/wheel in the browser, initial view
from ``Simulation.setViewport``.

    sim.start()
    lv = LiveViewer(sim)         # serves http://127.0.0.1:<port>/
    lv.start()
    sim.waitUntil(60.0)          # watch it run in the browser
    lv.stop()
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


class LiveViewer:
    """Concurrent snapshot server for a running Simulation."""

    def __init__(self, sim, port: int = 0, cadence: float = 0.05,
                 max_masses: Optional[int] = 20000,
                 max_springs: int = 20000,
                 record: bool = False, max_record_frames: int = 3000):
        self.sim = sim
        self.cadence = cadence
        self.max_masses = max_masses
        self.max_springs = max_springs
        self.record = record
        self.max_record_frames = max_record_frames
        self.frames = []             # recorded [n, 3] f32 (ring buffer)
        self.times = []
        self._frame = None           # (t, [n, 3] f32)
        self._frame_lock = threading.Lock()
        self._stop = threading.Event()
        self._server = ThreadingHTTPServer(("127.0.0.1", port),
                                           self._handler_cls())
        self.port = self._server.server_address[1]
        self._threads = []
        self._streams = {}           # device -> the viewer's copy stream
        sim._recorder = getattr(sim, "_recorder", None)  # fps() unaffected

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}/"

    def start(self) -> None:
        self._stop.clear()
        t1 = threading.Thread(target=self._serve, daemon=True,
                              name="titan-live-http")
        t2 = threading.Thread(target=self._sample, daemon=True,
                              name="titan-live-sample")
        self._threads = [t1, t2]
        t1.start()
        t2.start()

    def stop(self) -> None:
        self._stop.set()
        self._server.shutdown()
        for t in self._threads:
            t.join(timeout=5)

    # -- internals -----------------------------------------------------------
    def _serve(self) -> None:
        self._server.serve_forever(poll_interval=0.1)

    def _sample(self) -> None:
        while not self._stop.wait(self.cadence):
            self._sample_once()

    def _sample_once(self) -> None:
        with self.sim._lock:
            state = self.sim._state
            t = self.sim._T
            made = self.sim._state_ready
        if state is None:
            return
        ready = made[1] if made is not None and made[0] is state else None
        pos = self._host_copy(state.masses.pos, ready).astype(np.float32)
        n = self.sim._store.n_masses
        if self.max_masses:
            n = min(n, self.max_masses)
        frame = pos[:, :n].T.copy()
        with self._frame_lock:
            self._frame = (t, frame)
            if self.record and (not self.times or t > self.times[-1]):
                self.frames.append(frame)
                self.times.append(t)
                if len(self.frames) > self.max_record_frames:
                    # ring: drop the oldest half to amortize the pops
                    keep = self.max_record_frames // 2
                    self.frames = self.frames[-keep:]
                    self.times = self.times[-keep:]

    def _host_copy(self, x: torch.Tensor, ready) -> np.ndarray:
        """``x`` as a host numpy array.  A CUDA tensor is copied on the
        viewer's stream once ``ready`` (the event recorded at the end of
        the chunk that made it) has passed; without one (a state set at a
        pause), once the work queued so far has."""
        if not x.is_cuda:
            return x.numpy()
        side = self._streams.get(x.device)
        if side is None:
            side = self._streams[x.device] = torch.cuda.Stream(x.device)
        if ready is None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(x.device))
        side.wait_event(ready)
        with torch.cuda.stream(side):
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
        x.record_stream(side)
        side.synchronize()
        return host.numpy()

    def export_html_bytes(self) -> Optional[bytes]:
        """The recorded trajectory as a standalone viewer page (the same
        single-file format as runtime.viewer.Recorder.export_html)."""
        from .viewer import build_viewer_html
        with self._frame_lock:
            frames = list(self.frames)
            times = list(self.times)
        if not frames:
            return None
        return build_viewer_html(self.sim, frames, times,
                                 self.max_springs).encode()

    def export_html(self, path: str) -> None:
        body = self.export_html_bytes()
        if body is None:
            raise RuntimeError("nothing recorded (pass record=True and let "
                               "the simulation run)")
        with open(path, "wb") as fh:
            fh.write(body)

    def _topology(self) -> dict:
        st = self.sim._store
        s = min(st.n_springs, self.max_springs)
        edges = np.stack([st.left[:s], st.right[:s]], axis=1)
        n_cap = (min(st.n_masses, self.max_masses) if self.max_masses
                 else st.n_masses)
        edges = edges[(edges[:, 0] >= 0) & (edges[:, 1] >= 0)
                      & (edges < n_cap).all(axis=1)]
        cam = getattr(self.sim, "_camera", None)
        # per-mass render colors (mass.h:50; Mass.color / setColor)
        cols = np.clip(st.color[:n_cap], 0.0, 1.0)
        hexes = [f"#{int(r*255):02x}{int(g*255):02x}{int(b*255):02x}"
                 for r, g, b in cols]
        return {
            "edges": edges.tolist(),
            "colors": hexes,
            "planes": [[p[0].tolist(), float(p[1])]
                       for p in self.sim._planes],
            "balls": [[b[0].tolist(), float(b[1])]
                      for b in self.sim._balls],
            "camera": ([cam[0].tolist(), cam[1].tolist()]
                       if cam is not None else None),
            "record": self.record,
        }

    def _handler_cls(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/":
                    self._send(_PAGE.encode(), "text/html; charset=utf-8")
                elif self.path == "/topology":
                    self._send(json.dumps(viewer._topology()).encode(),
                               "application/json")
                elif self.path == "/export.html":
                    body = viewer.export_html_bytes()
                    if body is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "text/html; charset=utf-8")
                    self.send_header("Content-Disposition",
                                     "attachment; "
                                     "filename=titan_live_recording.html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame":
                    with viewer._frame_lock:
                        fr = viewer._frame
                    if fr is None:
                        body = json.dumps({"t": None}).encode()
                    else:
                        t, pos = fr
                        body = json.dumps({
                            "t": round(float(t), 6),
                            "running": viewer.sim.running(),
                            "pos": np.round(pos, 4).tolist(),
                        }).encode()
                    self._send(body, "application/json")
                else:
                    self.send_response(404)
                    self.end_headers()

        return Handler


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>titan-tpu live</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud">connecting...</div><canvas id="c"></canvas><script>
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); addEventListener('resize', rs);
let yaw = 0.6, pitch = 0.4, dist = 2.5, topo = null, frame = null;
let colorGroups = null;
let drag = false, lx, ly;
cv.onmousedown = e => {drag = true; lx = e.clientX; ly = e.clientY;};
onmouseup = () => drag = false;
onmousemove = e => { if (drag) { yaw += (e.clientX-lx)*0.01;
  pitch += (e.clientY-ly)*0.01; lx = e.clientX; ly = e.clientY; } };
cv.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); };
// keyboard camera control during a live run (the reference polls keys
// inside its render loop, sim.cu:1816-1837): arrows/WASD orbit,
// +/- zoom, R resets
onkeydown = e => {
  const s = 0.08;
  if (e.key === 'ArrowLeft' || e.key === 'a') yaw -= s;
  else if (e.key === 'ArrowRight' || e.key === 'd') yaw += s;
  else if (e.key === 'ArrowUp' || e.key === 'w') pitch -= s;
  else if (e.key === 'ArrowDown' || e.key === 's') pitch += s;
  else if (e.key === '+' || e.key === '=') dist *= 0.9;
  else if (e.key === '-') dist *= 1.1;
  else if (e.key === 'r') { yaw = 0.6; pitch = 0.4; dist = 2.5; }
};
let ctr = [0,0,0], scl = 1;
function refreshTopo(t){
  topo = t;
  colorGroups = null;  // re-derive: colors/edges may have been edited
}
// topology (edges, colors) can change while the page is open
// (incremental edits, setColor at a pause) -- re-pull every ~2 s
setInterval(() => {
  fetch('/topology').then(r => r.json()).then(refreshTopo).catch(()=>{});
}, 2000);
fetch('/topology').then(r => r.json()).then(t => {
  refreshTopo(t);
  if (t.record) {
    const a = document.createElement('a');
    a.href = '/export.html'; a.download = 'titan_live_recording.html';
    a.textContent = 'save recording'; a.style.color = '#8cf';
    a.style.position = 'fixed'; a.style.top = '8px'; a.style.right = '12px';
    document.body.appendChild(a);
  }
  if (t.camera) {
    const [cp, tg] = t.camera;
    const v = [cp[0]-tg[0], cp[1]-tg[1], cp[2]-tg[2]];
    yaw = Math.atan2(v[0], v[1]);
    pitch = Math.atan2(-v[2], Math.hypot(v[0], v[1]));
  }
});
async function poll(){
  try {
    const r = await fetch('/frame'); const f = await r.json();
    if (f.t !== null) frame = f;
  } catch (e) {}
  setTimeout(poll, 50);
}
poll();
function proj(p){
  let x=(p[0]-ctr[0])*scl, y=(p[1]-ctr[1])*scl, z=(p[2]-ctr[2])*scl;
  let x1=x*Math.cos(yaw)-y*Math.sin(yaw), y1=x*Math.sin(yaw)+y*Math.cos(yaw);
  let y2=y1*Math.cos(pitch)-z*Math.sin(pitch);
  let z2=y1*Math.sin(pitch)+z*Math.cos(pitch);
  const f=1/(dist - y2*0.5);
  return [W/2 + x1*f*W*0.6, H/2 - z2*f*W*0.6];
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  if (frame && frame.pos.length) {
    let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
    for (const p of frame.pos) for (let i=0;i<3;i++)
      { mn[i]=Math.min(mn[i],p[i]); mx[i]=Math.max(mx[i],p[i]); }
    ctr = mn.map((v,i)=>(v+mx[i])/2);
    scl = 1/Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 1e-9);
    const pts = frame.pos.map(proj);
    if (topo) {
      ctx.strokeStyle='rgba(120,170,255,0.25)';
      ctx.beginPath();
      for (const [a,b] of topo.edges)
        if (a < pts.length && b < pts.length) {
          ctx.moveTo(pts[a][0],pts[a][1]); ctx.lineTo(pts[b][0],pts[b][1]);
        }
      ctx.stroke();
    }
    if (topo && topo.colors && !colorGroups) {
      colorGroups = new Map();
      topo.colors.forEach((c, i) => {
        if (!colorGroups.has(c)) colorGroups.set(c, []);
        colorGroups.get(c).push(i);
      });
    }
    if (colorGroups) {
      for (const [col, idxs] of colorGroups) {
        ctx.fillStyle = col;
        for (const i of idxs) if (i < pts.length)
          ctx.fillRect(pts[i][0]-1.5, pts[i][1]-1.5, 3, 3);
      }
    } else {
      ctx.fillStyle='#ff5a5a';
      for (const p of pts) ctx.fillRect(p[0]-1.5, p[1]-1.5, 3, 3);
    }
    document.getElementById('hud').textContent =
      't=' + frame.t.toFixed(3) + 's  ' +
      (frame.running ? 'running' : 'paused') +
      '  (drag=rotate, wheel=zoom)';
  }
  requestAnimationFrame(draw);
}
draw();
</script></body></html>
"""
