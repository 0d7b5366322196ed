"""Self-contained HTML scene dumps for debugging solves.

The reference's observability is rviz topics (corridor polyhedra, uncertainty
ellipsoids, reference/NMPC trajectories rendered by the vendored plugins,
decomp_ros_utils/src/*).  This module writes the same information as a single
offline HTML file with an embedded top-down/side canvas viewer — zero
dependencies, works over any file transfer.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>resilient planner scene</title>
<style>
 body {{ font-family: monospace; background: #111; color: #ddd; margin: 1em; }}
 canvas {{ background: #181818; border: 1px solid #333; }}
 .row {{ display: flex; gap: 1em; }}
</style></head><body>
<h3>forces_resilient_planner_tpu scene dump</h3>
<div class="row">
 <div><div>top view (x-y)</div><canvas id="xy" width="640" height="640"></canvas></div>
 <div><div>side view (x-z)</div><canvas id="xz" width="640" height="400"></canvas></div>
</div>
<pre id="meta"></pre>
<script>
const D = {data};
function draw(id, ax0, ax1) {{
  const cv = document.getElementById(id), ctx = cv.getContext('2d');
  const pts = [].concat(D.obstacles, D.ref, D.traj, D.kino || []);
  let mn=[1e9,1e9], mx=[-1e9,-1e9];
  for (const p of pts) {{
    mn[0]=Math.min(mn[0],p[ax0]); mn[1]=Math.min(mn[1],p[ax1]);
    mx[0]=Math.max(mx[0],p[ax0]); mx[1]=Math.max(mx[1],p[ax1]);
  }}
  const pad=0.8; mn[0]-=pad; mn[1]-=pad; mx[0]+=pad; mx[1]+=pad;
  const sx = cv.width/(mx[0]-mn[0]), sy = cv.height/(mx[1]-mn[1]);
  const s = Math.min(sx, sy);
  const X = p => (p[ax0]-mn[0])*s, Y = p => cv.height-(p[ax1]-mn[1])*s;
  ctx.fillStyle = '#666';
  for (const p of D.obstacles) ctx.fillRect(X(p)-1.5, Y(p)-1.5, 3, 3);
  function poly(line, color, w) {{
    ctx.strokeStyle = color; ctx.lineWidth = w; ctx.beginPath();
    line.forEach((p,i) => i ? ctx.lineTo(X(p),Y(p)) : ctx.moveTo(X(p),Y(p)));
    ctx.stroke();
  }}
  if (D.kino && D.kino.length) poly(D.kino, '#4c8fcc', 1.5);
  poly(D.ref, '#3c78aa', 1);
  poly(D.traj, '#cc4444', 2);
  // ellipsoid radii as circles at trajectory points
  ctx.strokeStyle = '#888844';
  for (let i = 0; i < D.traj.length; i++) {{
    const r = D.ellipsoid_r[i] * s;
    ctx.beginPath(); ctx.arc(X(D.traj[i]), Y(D.traj[i]), r, 0, 6.283); ctx.stroke();
  }}
  // corridor wall intersections with this plane are drawn as chords around
  // each stage reference point
  ctx.strokeStyle = '#44aa66'; ctx.lineWidth = 0.6;
  for (const seg of D.corridor_segs[id] || []) {{
    ctx.beginPath(); ctx.moveTo(X(seg[0]), Y(seg[0]));
    ctx.lineTo(X(seg[1]), Y(seg[1])); ctx.stroke();
  }}
  // polyhedron silhouettes (PolyhedronArray display analog)
  ctx.strokeStyle = '#2e7d4f'; ctx.lineWidth = 1.0;
  for (const ring of D.corridor_polys[id] || []) poly(ring, '#2e7d4f', 1.0);
  ctx.fillStyle = '#44cc44';
  const g = D.goal; ctx.fillRect(X(g)-4, Y(g)-4, 8, 8);
}}
draw('xy', 0, 1); draw('xz', 0, 2);
document.getElementById('meta').textContent = JSON.stringify(D.meta, null, 1);
</script></body></html>
"""


def _corridor_chords(A, b, centers, axes, half_len=2.5):
    """For each stage, intersect each corridor plane with the view plane
    through the stage center: draw a chord of the wall line."""
    segs = []
    ax0, ax1 = axes
    for i in range(len(centers)):
        c = centers[i]
        for j in range(A.shape[1]):
            n = A[i, j]
            if np.linalg.norm(n) < 1e-9:
                continue
            n2 = np.array([n[ax0], n[ax1]])
            nn = np.linalg.norm(n2)
            if nn < 1e-6:
                continue
            n2 /= nn
            # distance from center to the wall along n2 (projected)
            d = (b[i, j] - A[i, j] @ c) / nn
            if not (0 <= d <= 3.0):
                continue
            p0 = np.array([c[ax0], c[ax1]]) + d * n2
            t = np.array([-n2[1], n2[0]])
            a_pt = p0 - half_len * t
            b_pt = p0 + half_len * t
            def lift(q):
                out = [0.0, 0.0, 0.0]
                out[ax0], out[ax1] = float(q[0]), float(q[1])
                return out
            segs.append([lift(a_pt), lift(b_pt)])
    return segs


def _corridor_outlines(A, b, axes):
    """Project each stage polyhedron's vertex hull onto the view plane and
    return closed 2D outlines (the rviz PolyhedronArray display analog,
    decomp_ros_utils/src/polyhedron_array_display.cpp, rendered flat)."""
    from forces_resilient_planner_tpu_torch.corridor.geometry import (
        polyhedron_vertices,
    )

    ax0, ax1 = axes
    outlines = []
    for i in range(len(A)):
        try:
            pf = polyhedron_vertices(A[i], b[i])
        except Exception:
            continue
        V = pf.vertices
        if len(V) < 3:
            continue
        p2 = V[:, [ax0, ax1]]
        # silhouette = 2D convex hull of the projected vertices
        # (Andrew's monotone chain; V <= ~100)
        pts = sorted(map(tuple, p2))
        if len(pts) < 3:
            continue

        def half(seq):
            out = []
            for q in seq:
                while len(out) >= 2 and (
                    (out[-1][0] - out[-2][0]) * (q[1] - out[-2][1])
                    - (out[-1][1] - out[-2][1]) * (q[0] - out[-2][0])
                ) <= 0:
                    out.pop()
                out.append(q)
            return out

        lower, upper = half(pts), half(pts[::-1])
        hull = np.asarray(lower[:-1] + upper[:-1])

        def lift(q):
            out = [0.0, 0.0, 0.0]
            out[ax0], out[ax1] = float(q[0]), float(q[1])
            return out

        ring = [lift(q) for q in hull]
        ring.append(ring[0])
        outlines.append(ring)
    return outlines


def dump_scene(
    path: str | Path,
    traj: np.ndarray,            # (N, 3) NMPC positions
    ref: np.ndarray,             # (N, 3) references
    goal: np.ndarray,
    obstacles: np.ndarray | None = None,
    corridor_A: np.ndarray | None = None,   # (N, nh, 3)
    corridor_b: np.ndarray | None = None,
    tube_E: np.ndarray | None = None,       # (N, 3, 3)
    kino_path: np.ndarray | None = None,
    meta: dict | None = None,
):
    traj = np.asarray(traj, float)
    ref = np.asarray(ref, float)
    ell_r = (
        [float(np.linalg.norm(E, 2)) for E in np.asarray(tube_E)]
        if tube_E is not None
        else [0.0] * len(traj)
    )
    segs = {"xy": [], "xz": []}
    polys = {"xy": [], "xz": []}
    if corridor_A is not None:
        A = np.asarray(corridor_A)
        b = np.asarray(corridor_b)
        segs["xy"] = _corridor_chords(A, b, ref, (0, 1))
        segs["xz"] = _corridor_chords(A, b, ref, (0, 2))
        polys["xy"] = _corridor_outlines(A, b, (0, 1))
        polys["xz"] = _corridor_outlines(A, b, (0, 2))
    data = {
        "traj": traj.tolist(),
        "ref": ref.tolist(),
        "goal": np.asarray(goal, float).tolist(),
        "obstacles": (
            np.asarray(obstacles, float).tolist() if obstacles is not None else []
        ),
        "ellipsoid_r": ell_r,
        "corridor_segs": segs,
        "corridor_polys": polys,
        "kino": (
            np.asarray(kino_path, float).tolist() if kino_path is not None else []
        ),
        "meta": meta or {},
    }
    Path(path).write_text(_TEMPLATE.format(data=json.dumps(data)))
    return Path(path)


_REPLAY_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>resilient planner replay</title>
<style>
 body { font-family: monospace; background: #111; color: #ddd; margin: 1em; }
 canvas { background: #181818; border: 1px solid #333; }
 .row { display: flex; gap: 1em; }
 input[type=range] { width: 640px; }
 button { font-family: monospace; }
</style></head><body>
<h3>forces_resilient_planner_tpu flight replay</h3>
<div class="row">
 <div><div>top view (x-y)</div><canvas id="xy" width="640" height="640"></canvas></div>
 <div><div>side view (x-z)</div><canvas id="xz" width="640" height="400"></canvas></div>
</div>
<div><button id="play">play</button>
 <input type="range" id="tk" min="0" value="0" step="1">
 <span id="lbl"></span></div>
<pre id="meta"></pre>
<script>
const D = REPLAY_DATA;
const T = D.pos.length;
document.getElementById('tk').max = T - 1;
function bounds() {
  const pts = [].concat(D.obstacles, D.pos, [D.goal]);
  let mn=[1e9,1e9,1e9], mx=[-1e9,-1e9,-1e9];
  for (const p of pts) for (let a=0;a<3;a++) {
    mn[a]=Math.min(mn[a],p[a]); mx[a]=Math.max(mx[a],p[a]); }
  for (let a=0;a<3;a++) { mn[a]-=0.8; mx[a]+=0.8; }
  return [mn, mx];
}
const [MN, MX] = bounds();
function planAt(k) {
  // latest plan snapshot with t <= t_k
  const t = D.t[k];
  let best = null;
  for (const s of D.plans) { if (s[0] <= t) best = s[1]; else break; }
  return best;
}
function draw(k) {
  for (const [id, ax0, ax1] of [["xy",0,1],["xz",0,2]]) {
    const cv = document.getElementById(id), ctx = cv.getContext('2d');
    ctx.clearRect(0,0,cv.width,cv.height);
    const s = Math.min(cv.width/(MX[ax0]-MN[ax0]), cv.height/(MX[ax1]-MN[ax1]));
    const X = p => (p[ax0]-MN[ax0])*s, Y = p => cv.height-(p[ax1]-MN[ax1])*s;
    ctx.fillStyle = '#666';
    for (const p of D.obstacles) ctx.fillRect(X(p)-1.5, Y(p)-1.5, 3, 3);
    function poly(line, color, w) {
      ctx.strokeStyle = color; ctx.lineWidth = w; ctx.beginPath();
      line.forEach((p,i) => i ? ctx.lineTo(X(p),Y(p)) : ctx.moveTo(X(p),Y(p)));
      ctx.stroke();
    }
    poly(D.pos.slice(0, k+1), '#cc8844', 1.5);          // flown path so far
    const plan = planAt(k);
    if (plan) poly(plan, '#cc4444', 2);                  // active NMPC plan
    const p = D.pos[k];
    ctx.fillStyle = '#44ccee';
    ctx.beginPath(); ctx.arc(X(p), Y(p), 5, 0, 6.283); ctx.fill();
    // external force arrow (5x exaggerated)
    const f = D.force[k];
    ctx.strokeStyle = '#cc44cc'; ctx.lineWidth = 2; ctx.beginPath();
    ctx.moveTo(X(p), Y(p));
    const q = [p[0]+0.2*f[0], p[1]+0.2*f[1], p[2]+0.2*f[2]];
    ctx.lineTo(X(q), Y(q)); ctx.stroke();
    ctx.fillStyle = '#44cc44';
    const g = D.goal; ctx.fillRect(X(g)-4, Y(g)-4, 8, 8);
  }
  document.getElementById('lbl').textContent =
    't=' + D.t[k].toFixed(2) + 's  state=' + D.state[k] +
    '  |f|=' + Math.hypot(...D.force[k]).toFixed(2);
}
const tk = document.getElementById('tk');
tk.oninput = () => draw(+tk.value);
let timer = null;
document.getElementById('play').onclick = function() {
  if (timer) { clearInterval(timer); timer = null; this.textContent='play'; return; }
  this.textContent = 'pause';
  timer = setInterval(() => {
    tk.value = (+tk.value + 2) % T; draw(+tk.value);
  }, 20);
};
draw(0);
document.getElementById('meta').textContent = JSON.stringify(D.meta, null, 1);
</script></body></html>
"""


def dump_replay(
    path: str | Path,
    trace: dict,                 # run_closed_loop trace (record_plans=True)
    goal: np.ndarray,
    obstacles: np.ndarray | None = None,
    meta: dict | None = None,
    stride: int = 2,
) -> Path:
    """Animated closed-loop flight replay (play button + time scrubber).

    The interactive analog of the reference's rviz session
    (decomp_ros_utils/src/polyhedron_array_display.cpp renders live
    topics; here the whole flight is a single self-contained HTML file):
    flown path, active NMPC plan per solve tick, external-force vector and
    FSM state over time.  `trace` is run_closed_loop's dict — pass
    record_plans=True there to overlay the accepted plan snapshots.
    """
    pos = np.asarray(trace["pos"], float)[::stride]
    t = np.asarray(trace["t"], float)[::stride]
    force = np.asarray(trace["force"], float)[::stride]
    state = list(trace["state"])[::stride]
    plans = [
        (float(tp), np.asarray(p, float)[:, :3].tolist())
        for tp, p in trace.get("plans", [])
    ]
    data = {
        "t": t.tolist(),
        "pos": pos.tolist(),
        "force": force.tolist(),
        "state": state,
        "plans": plans,
        "goal": np.asarray(goal, float).tolist(),
        "obstacles": (
            np.asarray(obstacles, float).tolist()
            if obstacles is not None else []
        ),
        "meta": meta or {},
    }
    path = Path(path)
    path.write_text(
        _REPLAY_TEMPLATE.replace("REPLAY_DATA", json.dumps(data))
    )
    return path
