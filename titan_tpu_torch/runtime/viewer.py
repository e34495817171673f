"""Out-of-loop visualization: record frames, export standalone viewers (a
copy of ``titan_tpu/runtime/viewer.py``).

The reference renders masses/springs with CUDA-GL interop inside the step
loop (sim.cu:1944-2052, disabled for tests).  Here rendering is decoupled
from stepping entirely: a ``Recorder`` snapshots positions at the
reference's render cadence (every 0.01 sim-seconds, sim.cu:1816), and the
trajectory exports to

- ``.npz``  (frames + spring topology) for offline tooling,
- ``.html`` (a single self-contained file with an interactive 3-D
  point/line canvas viewer -- zero dependencies),
- ``.png``  frames via matplotlib when it's installed.
"""

from __future__ import annotations

import json
from typing import List, Optional

import numpy as np

RENDER_DT = 0.01  # reference render cadence (sim.cu:1816)


class Recorder:
    """Record mass positions every ``cadence`` sim-seconds.

        rec = Recorder(sim)
        sim.start()
        rec.run_until(3.0)      # steps the sim, capturing frames
        sim.stop()
        rec.export_html("out.html")
    """

    def __init__(self, sim, cadence: float = RENDER_DT,
                 max_masses: Optional[int] = None):
        self.sim = sim
        self.cadence = cadence
        self.max_masses = max_masses
        self.frames: List[np.ndarray] = []
        self.times: List[float] = []
        self._wall0 = None
        sim._recorder = self  # lets sim.fps() report the capture rate

    def fps(self) -> float:
        """Frames captured per wall-clock second (reference fps(),
        sim.cu:1201-1214)."""
        import time as _time
        if self._wall0 is None or len(self.frames) < 2:
            return -1.0
        return len(self.frames) / (_time.monotonic() - self._wall0)

    def capture(self) -> None:
        if self._wall0 is None:
            import time as _time
            self._wall0 = _time.monotonic()
        self.sim.getAll()
        n = self.sim._store.n_masses
        if self.max_masses:
            n = min(n, self.max_masses)
        self.frames.append(self.sim._store.pos[:n].astype(np.float32).copy())
        self.times.append(self.sim.time())

    def run_until(self, t_end: float) -> None:
        """Advance the (started) simulation, capturing at the cadence."""
        if not self.frames:
            self.capture()
        while self.sim.time() < t_end - 1e-12:
            self.sim.wait(min(self.cadence, t_end - self.sim.time()))
            self.capture()
            self.sim.resume() if self.sim.time() < t_end - 1e-12 else None

    # -- exports ---------------------------------------------------------
    def save_npz(self, path: str) -> None:
        st = self.sim._store
        s = st.n_springs
        np.savez_compressed(
            path,
            frames=np.stack(self.frames),
            times=np.asarray(self.times),
            left=st.left[:s], right=st.right[:s],
            s_valid=st.s_valid[:s])

    def export_png(self, path_pattern: str, every: int = 1) -> int:
        """Write frames as PNGs via matplotlib (if installed); returns count."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return 0
        count = 0
        for fi in range(0, len(self.frames), every):
            fig = plt.figure(figsize=(6, 6))
            ax = fig.add_subplot(projection="3d")
            f = self.frames[fi]
            ax.scatter(f[:, 0], f[:, 1], f[:, 2], s=2)
            ax.set_title(f"t = {self.times[fi]:.3f}s")
            fig.savefig(path_pattern.format(fi))
            plt.close(fig)
            count += 1
        return count

    def export_html(self, path: str, max_springs: int = 20000) -> None:
        """Single-file interactive viewer (rotate/play), no dependencies."""
        html = build_viewer_html(self.sim, self.frames, self.times,
                                 max_springs)
        with open(path, "w") as fh:
            fh.write(html)


def build_viewer_html(sim, frames, times, max_springs: int = 20000) -> str:
    """Standalone-viewer HTML for a recorded (frames, times) trajectory;
    shared by Recorder.export_html and LiveViewer's /export.html download."""
    frames = np.stack(frames)                 # [T, n, 3]
    st = sim._store
    s = min(st.n_springs, max_springs)
    edges = np.stack([st.left[:s], st.right[:s]], axis=1)
    edges = edges[(edges[:, 0] >= 0) & (edges[:, 1] >= 0)
                  & (edges < frames.shape[1]).all(axis=1)]
    # initial view from setViewport/moveViewport (reference
    # sim.cu:1636-1661); the viewer is orbit-style so the camera maps to
    # (yaw, pitch, distance) about the scene center -- roll (up vector)
    # is not represented
    cam = getattr(sim, "_camera", None)
    # per-mass colors (mass.h:50; Mass.color / setColor): ship one hex
    # string per mass so the canvas can batch points by color
    cols = np.clip(st.color[:frames.shape[1]], 0.0, 1.0)
    hexes = [f"#{int(r*255):02x}{int(g*255):02x}{int(b*255):02x}"
             for r, g, b in cols]
    data = {
        "times": [round(float(t), 5) for t in times],
        "frames": np.round(frames, 4).tolist(),
        "edges": edges.tolist(),
        "colors": hexes,
        # constraint objects (reference renders checkerboard planes and
        # icospheres, object.cu:667-898; here: grid lines and circles)
        "planes": [[p[0].tolist(), float(p[1])]
                   for p in sim._planes],
        "balls": [[b[0].tolist(), float(b[1])]
                  for b in sim._balls],
        "camera": ([cam[0].tolist(), cam[1].tolist()]
                   if cam is not None else None),
    }
    return _HTML_TEMPLATE.replace("/*DATA*/", json.dumps(data))


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>titan-tpu viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
canvas{display:block}#hud{position:fixed;top:8px;left:8px}</style></head>
<body><div id="hud"></div><canvas id="c"></canvas><script>
const D = /*DATA*/;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
rs(); addEventListener('resize', rs);
let yaw = 0.6, pitch = 0.4, dist = 2.5, fi = 0, playing = true;
let drag = false, lx, ly;
cv.onmousedown = e => {drag = true; lx = e.clientX; ly = e.clientY;};
onmouseup = () => drag = false;
onmousemove = e => { if (drag) { yaw += (e.clientX-lx)*0.01;
  pitch += (e.clientY-ly)*0.01; lx = e.clientX; ly = e.clientY; } };
cv.onwheel = e => { dist *= Math.exp(e.deltaY*0.001); };
onkeydown = e => { if (e.key === ' ') playing = !playing; };
// bounding box for normalization
let mn = [1e9,1e9,1e9], mx = [-1e9,-1e9,-1e9];
for (const f of D.frames) for (const p of f) for (let i=0;i<3;i++)
  { mn[i]=Math.min(mn[i],p[i]); mx[i]=Math.max(mx[i],p[i]); }
const ctr = mn.map((v,i)=>(v+mx[i])/2);
const scl = 1/Math.max(mx[0]-mn[0], mx[1]-mn[1], mx[2]-mn[2], 1e-9);
// batch points by color (per-mass colors, Mass.color)
const colorGroups = new Map();
(D.colors || []).forEach((c, i) => {
  if (!colorGroups.has(c)) colorGroups.set(c, []);
  colorGroups.get(c).push(i);
});
if (!colorGroups.size)
  colorGroups.set('#ff5a5a', D.frames[0].map((_, i) => i));
if (D.camera) {  // initial view from Simulation.setViewport
  const [cp, tg] = D.camera;
  const v = [cp[0]-tg[0], cp[1]-tg[1], cp[2]-tg[2]];
  yaw = Math.atan2(v[0], v[1]);
  pitch = Math.atan2(-v[2], Math.hypot(v[0], v[1]));
  dist = Math.min(20, Math.max(0.8, Math.hypot(...v) * scl));
}
function proj(p){
  let x=(p[0]-ctr[0])*scl, y=(p[1]-ctr[1])*scl, z=(p[2]-ctr[2])*scl;
  let x1=x*Math.cos(yaw)-y*Math.sin(yaw), y1=x*Math.sin(yaw)+y*Math.cos(yaw);
  let y2=y1*Math.cos(pitch)-z*Math.sin(pitch);
  let z2=y1*Math.sin(pitch)+z*Math.cos(pitch);
  const f=1/(dist - y2*0.5);
  return [W/2 + x1*f*W*0.6, H/2 - z2*f*W*0.6];
}
function planeGrid(n, off){
  // orthonormal basis (u, v) of the plane a.x = off
  let u = Math.abs(n[2]) < 0.9 ? [ -n[1], n[0], 0 ] : [ 1, 0, 0 ];
  const nu = Math.hypot(...u); u = u.map(c => c / nu);
  const v = [ n[1]*u[2]-n[2]*u[1], n[2]*u[0]-n[0]*u[2], n[0]*u[1]-n[1]*u[0] ];
  const c = n.map(cc => cc * off);   // a point on the plane
  const ext = 0.8 / scl, lines = [];
  for (let i = -5; i <= 5; i++) {
    const s = i / 5 * ext;
    lines.push([c.map((cc,k)=>cc+u[k]*s-v[k]*ext), c.map((cc,k)=>cc+u[k]*s+v[k]*ext)]);
    lines.push([c.map((cc,k)=>cc+v[k]*s-u[k]*ext), c.map((cc,k)=>cc+v[k]*s+u[k]*ext)]);
  }
  return lines;
}
function draw(){
  ctx.fillStyle='#111'; ctx.fillRect(0,0,W,H);
  const f = D.frames[fi], pts = f.map(proj);
  ctx.strokeStyle='rgba(90,200,120,0.3)';
  ctx.beginPath();
  for (const [n, off] of D.planes)
    for (const [a, b] of planeGrid(n, off)) {
      const pa = proj(a), pb = proj(b);
      ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]);
    }
  ctx.stroke();
  ctx.strokeStyle='rgba(230,200,90,0.6)';
  for (const [c, r] of D.balls) {
    const pc = proj(c), pe = proj([c[0]+r, c[1], c[2]]);
    const pr = Math.hypot(pe[0]-pc[0], pe[1]-pc[1]);
    ctx.beginPath(); ctx.arc(pc[0], pc[1], pr, 0, 6.3); ctx.stroke();
  }
  ctx.strokeStyle='rgba(120,170,255,0.25)';
  ctx.beginPath();
  for (const [a,b] of D.edges){ ctx.moveTo(pts[a][0],pts[a][1]);
    ctx.lineTo(pts[b][0],pts[b][1]); }
  ctx.stroke();
  for (const [col, idxs] of colorGroups) {
    ctx.fillStyle = col;
    for (const i of idxs) ctx.fillRect(pts[i][0]-1.5, pts[i][1]-1.5, 3, 3);
  }
  document.getElementById('hud').textContent =
    't=' + D.times[fi].toFixed(3) + 's  frame ' + (fi+1) + '/' +
    D.frames.length + '  (drag=rotate, wheel=zoom, space=pause)';
  if (playing) fi = (fi + 1) % D.frames.length;
  requestAnimationFrame(draw);
}
draw();
</script></body></html>
"""
