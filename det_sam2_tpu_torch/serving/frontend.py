"""Single-page demo frontend (stdlib-served; dependency-free).

The reference ships a React editing UI (demo/frontend/src/ — gallery,
multi-object click editing, per-object colors, background/foreground video
effects, tracklet playback). This is the port's equivalent of its core
interactions in one HTML string served by serving/server.py:

  * session gallery + upload-path entry (GraphQL `videos` / `startSession`)
  * multi-object editing: an objects panel with per-object color chips,
    add/select/remove (GraphQL `removeObject`), active-object prompting
  * click prompts: left click = positive, right click = negative point,
    with point markers drawn over the frame (reference:
    demo/frontend/src/common/components/annotations)
  * streamed propagation (`/propagate_in_video` NDJSON) with a per-frame
    mask cache, playback (play/pause/scrub) over cached tracklets
  * video effects composited on canvas: background original/desaturate/
    darken/erase + per-object fill/outline highlight (reference:
    demo/frontend/src/common/components/video/effects)
"""

INDEX_HTML = r"""<!doctype html>
<html>
<head>
<meta charset="utf-8"/>
<title>det_sam2_tpu_torch demo</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 0; background:#101114;
        color:#eee; display:flex; flex-direction:column; height:100vh; }
 header { padding:.6rem 1rem; background:#17181c; font-weight:600; }
 header .sub { color:#9aa0a6; font-weight:400; font-size:.85rem; }
 #main { display:flex; flex:1; min-height:0; }
 #sidebar { width: 240px; background:#17181c; padding:.8rem; overflow-y:auto; }
 #stage { flex:1; display:flex; flex-direction:column; align-items:center;
          padding: .8rem; min-width:0; }
 #view-wrap { position:relative; }
 #view { max-width:100%; max-height:62vh; background:#000; cursor:crosshair; }
 button { background:#2b2d33; color:#eee; border:1px solid #3c3f46;
          border-radius:6px; padding:.3rem .6rem; margin:.15rem;
          cursor:pointer; }
 button:hover { background:#3c3f46; }
 button.primary { background:#2457d6; border-color:#2457d6; }
 select, input { background:#2b2d33; color:#eee; border:1px solid #3c3f46;
          border-radius:4px; padding:.2rem .3rem; }
 input[type=number]{ width:4.5rem; }
 input[type=range]{ width: 100%; padding:0; }
 .obj-row { display:flex; align-items:center; gap:.4rem; padding:.3rem .4rem;
            border-radius:6px; margin-bottom:.25rem; cursor:pointer;
            border:1px solid transparent; }
 .obj-row.active { border-color:#2457d6; background:#1d2026; }
 .chip { width:14px; height:14px; border-radius:50%; flex:none; }
 .obj-row .del { margin-left:auto; color:#9aa0a6; }
 .section { margin-bottom:.9rem; }
 .section h4 { margin:.2rem 0 .4rem; font-size:.8rem; color:#9aa0a6;
               text-transform:uppercase; letter-spacing:.05em; }
 #timeline { width:100%; max-width:900px; }
 #log { white-space:pre-wrap; font-family:monospace; font-size:.72rem;
        height:7rem; overflow-y:auto; background:#000; padding:.4rem;
        width:100%; max-width:900px; box-sizing:border-box; }
 #hint { color:#9aa0a6; font-size:.8rem; margin:.3rem 0; }
</style>
</head>
<body>
<header>det_sam2_tpu_torch — interactive video segmentation
  <span class="sub">left click: add point · right click: negative point</span>
</header>
<div id="main">
 <div id="sidebar">
  <div class="section">
   <h4>Video</h4>
   <input id="video-path" size="22" placeholder="/path/to/video.mp4"/>
   <button onclick="loadGallery()">gallery</button>
   <select id="gallery" onchange="pickGallery()" style="width:100%"></select>
   <button class="primary" onclick="startSession()">start session</button>
   <button onclick="closeSession()">close</button>
  </div>
  <div class="section">
   <h4>Objects</h4>
   <div id="objects"></div>
   <button onclick="addObject()">+ add object</button>
  </div>
  <div class="section">
   <h4>Effects</h4>
   background
   <select id="bg-effect" onchange="render()">
     <option value="original">original</option>
     <option value="desaturate">desaturate</option>
     <option value="darken">darken</option>
     <option value="erase">erase</option>
   </select><br/>
   highlight
   <select id="fg-effect" onchange="render()">
     <option value="fill">fill</option>
     <option value="outline">outline</option>
     <option value="both">fill + outline</option>
     <option value="none">original</option>
   </select>
  </div>
  <div class="section">
   <h4>Tracking</h4>
   <button class="primary" onclick="propagate()">track objects</button>
   <button onclick="cancelProp()">cancel</button><br/>
   <button onclick="clearFrame()">clear frame prompts</button>
   <button onclick="resetAll()">reset session</button>
  </div>
 </div>
 <div id="stage">
  <div id="view-wrap">
    <canvas id="view" width="960" height="540"
      onclick="clickPoint(event, 1)"
      oncontextmenu="clickPoint(event, 0); return false;"></canvas>
  </div>
  <div id="hint">start a session, add objects, click to prompt, then
    track — scrub or play to review cached tracklets</div>
  <div id="timeline">
    <input type="range" id="scrub" min="0" max="0" value="0"
           oninput="seek(+this.value)"/>
    <button onclick="step(-1)">⟨</button>
    <button id="play-btn" onclick="togglePlay()">play</button>
    <button onclick="step(1)">⟩</button>
    frame <input type="number" id="frame-idx" value="0" min="0"
      onchange="seek(+this.value)"/>
    <span id="frame-count"></span>
  </div>
  <div id="log"></div>
 </div>
</div>
<script>
let SID = null, NFRAMES = 0, VW = 0, VH = 0;
let OBJECTS = [];           // [{id}]
let NEXT_OBJ_ID = 1;        // monotonic: ids are never reused, so a failed
                            // server-side remove can't leak stale prompts
                            // into a later object with the same id
let ACTIVE = null;          // active object id
let POINTS = {};            // objId -> {frameIdx: [[x, y, label], ...]}
let MASKS = {};             // frameIdx -> [{objectId, rleMask}]
let PLAYING = null;
let FRAME_IMG = new Image();
const COLORS = ["#ff3b30","#34c759","#007aff","#ffcc00","#af52de","#ff9500",
                "#5ac8fa","#ff2d55"];
const colorOf = id => COLORS[id % COLORS.length];
function log(m){ const el = document.getElementById("log");
  el.textContent += m + "\n"; el.scrollTop = el.scrollHeight; }
async function gql(query, variables){
  const r = await fetch("/graphql", {method:"POST",
    headers:{"Content-Type":"application/json"},
    body: JSON.stringify({query, variables})});
  const j = await r.json();
  if (j.errors) { log("error: " + j.errors[0].message); throw j.errors[0]; }
  return j.data;
}
async function loadGallery(){
  const d = await gql("query { videos { edges { node { path } } } }");
  const sel = document.getElementById("gallery");
  sel.innerHTML = "";
  for (const e of d.videos.edges){
    const o = document.createElement("option");
    o.value = e.node.path; o.textContent = e.node.path.split("/").pop();
    sel.appendChild(o);
  }
  if (sel.options.length) pickGallery();
}
function pickGallery(){
  document.getElementById("video-path").value =
    document.getElementById("gallery").value;
}
async function startSession(){
  const path = document.getElementById("video-path").value;
  const d = await gql(
    "mutation($i: StartSessionInput!) { startSession(input: $i) { sessionId } }",
    {i: {path}});
  SID = d.startSession.sessionId;
  const info = await fetch("/session_info?session_id=" + SID).then(r=>r.json());
  NFRAMES = info.num_frames; VW = info.video_width; VH = info.video_height;
  OBJECTS = []; POINTS = {}; MASKS = {}; ACTIVE = null; NEXT_OBJ_ID = 1;
  addObject();
  log(`session ${SID}: ${NFRAMES} frames ${VW}x${VH}`);
  const sc = document.getElementById("scrub");
  sc.max = NFRAMES - 1; sc.value = 0;
  document.getElementById("frame-idx").max = NFRAMES - 1;
  document.getElementById("frame-count").textContent = "/ " + (NFRAMES - 1);
  seek(0);
}
function addObject(){
  const id = NEXT_OBJ_ID++;
  OBJECTS.push({id}); ACTIVE = id; POINTS[id] = {};
  renderObjects();
}
function selectObject(id){ ACTIVE = id; renderObjects(); }
async function removeObject(id, ev){
  ev.stopPropagation();
  if (SID){
    try {
      await gql("mutation($i: RemoveObjectInput!) { removeObject(input: $i) "+
        "{ frameIndex } }", {i: {sessionId: SID, objectId: id}});
    } catch (e) {}
  }
  OBJECTS = OBJECTS.filter(o => o.id !== id);
  delete POINTS[id];
  for (const f in MASKS)
    MASKS[f] = MASKS[f].filter(m => m.objectId !== id);
  if (ACTIVE === id) ACTIVE = OBJECTS.length ? OBJECTS[0].id : null;
  renderObjects(); render();
}
function renderObjects(){
  const el = document.getElementById("objects");
  el.innerHTML = "";
  for (const o of OBJECTS){
    const row = document.createElement("div");
    row.className = "obj-row" + (o.id === ACTIVE ? " active" : "");
    row.onclick = () => selectObject(o.id);
    const chip = document.createElement("span");
    chip.className = "chip"; chip.style.background = colorOf(o.id);
    const name = document.createElement("span");
    name.textContent = "object " + o.id;
    const del = document.createElement("span");
    del.className = "del"; del.textContent = "✕";
    del.onclick = (ev) => removeObject(o.id, ev);
    row.append(chip, name, del);
    el.appendChild(row);
  }
}
function curFrame(){ return +document.getElementById("frame-idx").value; }
function seek(idx){
  idx = Math.max(0, Math.min(idx, NFRAMES - 1));
  document.getElementById("frame-idx").value = idx;
  document.getElementById("scrub").value = idx;
  if (!SID) return;
  FRAME_IMG = new Image();
  FRAME_IMG.onload = render;
  FRAME_IMG.src = `/frame?session_id=${SID}&index=${idx}`;
}
function step(d){ seek(curFrame() + d); }
function togglePlay(){
  const btn = document.getElementById("play-btn");
  if (PLAYING){ clearInterval(PLAYING); PLAYING = null;
    btn.textContent = "play"; return; }
  btn.textContent = "pause";
  PLAYING = setInterval(() => {
    const nxt = curFrame() + 1;
    if (nxt >= NFRAMES){ togglePlay(); return; }
    seek(nxt);
  }, 100);
}
async function clickPoint(ev, label){
  if (!SID) return log("start a session first");
  if (ACTIVE === null) return log("add an object first");
  const cv = document.getElementById("view");
  const rect = cv.getBoundingClientRect();
  const x = (ev.clientX - rect.left) / rect.width * VW;
  const y = (ev.clientY - rect.top) / rect.height * VH;
  const frameIndex = curFrame();
  const obj = ACTIVE;
  const pt = [x, y, label];
  (POINTS[obj][frameIndex] ||= []).push(pt);
  render();  // marker feedback before the round-trip
  try {
    const d = await gql(
      "mutation($i: AddPointsInput!) { addPoints(input: $i) { frameIndex " +
      "rleMaskList { objectId rleMask { size counts } } } }",
      {i: {sessionId: SID, frameIndex, objectId: obj,
           points: [[x, y]], labels: [label], clearOldPoints: false}});
    MASKS[frameIndex] = d.addPoints.rleMaskList;
  } catch (e) {
    // the server never saw this prompt: take THIS optimistic marker back
    // (pop() could remove a newer concurrent click's marker instead)
    const pts = (POINTS[obj] || {})[frameIndex];
    const i = pts ? pts.indexOf(pt) : -1;
    if (i >= 0) pts.splice(i, 1);
    log("add point failed: " + e);
  }
  render();
}
function decodeRLE(rle){  // column-major uncompressed counts
  const [h, w] = rle.size;
  const m = new Uint8Array(h * w);
  let idx = 0, val = 0;
  for (const c of rle.counts){ m.fill(val, idx, idx + c); idx += c; val ^= 1; }
  return {m, h, w};  // column-major
}
function maskCanvas(rle){
  // {fill, outline} canvases at mask resolution
  const {m, h, w} = decodeRLE(rle);
  const fill = document.createElement("canvas");
  fill.width = w; fill.height = h;
  const fctx = fill.getContext("2d");
  const fd = fctx.createImageData(w, h);
  const edge = document.createElement("canvas");
  edge.width = w; edge.height = h;
  const ectx = edge.getContext("2d");
  const ed = ectx.createImageData(w, h);
  const at = (x, y) => (x < 0 || y < 0 || x >= w || y >= h)
      ? 0 : m[x * h + y];
  for (let x = 0; x < w; x++) for (let y = 0; y < h; y++){
    if (!m[x * h + y]) continue;
    const o = (y * w + x) * 4;
    fd.data[o + 3] = 255;
    if (!at(x-1,y) || !at(x+1,y) || !at(x,y-1) || !at(x,y+1))
      ed.data[o + 3] = 255;
  }
  fctx.putImageData(fd, 0, 0);
  ectx.putImageData(ed, 0, 0);
  return {fill, edge};
}
function tinted(src, color, alpha){
  const c = document.createElement("canvas");
  c.width = src.width; c.height = src.height;
  const ctx = c.getContext("2d");
  ctx.drawImage(src, 0, 0);
  ctx.globalCompositeOperation = "source-in";
  ctx.globalAlpha = alpha;
  ctx.fillStyle = color;
  ctx.fillRect(0, 0, c.width, c.height);
  return c;
}
function render(){
  const cv = document.getElementById("view");
  const ctx = cv.getContext("2d");
  if (!FRAME_IMG.naturalWidth){ return; }
  cv.width = FRAME_IMG.naturalWidth; cv.height = FRAME_IMG.naturalHeight;
  const bg = document.getElementById("bg-effect").value;
  const fg = document.getElementById("fg-effect").value;
  // 1. background with effect
  ctx.filter = bg === "desaturate" ? "grayscale(1) brightness(.75)"
             : bg === "darken" ? "brightness(.35)" : "none";
  if (bg === "erase"){ ctx.fillStyle = "#000";
    ctx.fillRect(0, 0, cv.width, cv.height); }
  else ctx.drawImage(FRAME_IMG, 0, 0, cv.width, cv.height);
  ctx.filter = "none";
  const list = MASKS[curFrame()] || [];
  const live = new Set(OBJECTS.map(o => o.id));
  for (const item of list){
    if (!live.has(item.objectId)) continue;
    // mask items are replaced wholesale on update, so the decoded
    // canvases cached on the item can never go stale
    const {fill, edge} = (item._mc ||= maskCanvas(item.rleMask));
    // 2. foreground keeps ORIGINAL pixels inside the mask
    if (bg !== "original"){
      const fgc = document.createElement("canvas");
      fgc.width = cv.width; fgc.height = cv.height;
      const fctx = fgc.getContext("2d");
      fctx.drawImage(FRAME_IMG, 0, 0, cv.width, cv.height);
      fctx.globalCompositeOperation = "destination-in";
      fctx.imageSmoothingEnabled = false;
      fctx.drawImage(fill, 0, 0, cv.width, cv.height);
      ctx.drawImage(fgc, 0, 0);
    }
    // 3. per-object highlight
    ctx.imageSmoothingEnabled = false;
    const col = colorOf(item.objectId);
    if (fg === "fill" || fg === "both")
      ctx.drawImage(tinted(fill, col, 0.45), 0, 0, cv.width, cv.height);
    if (fg === "outline" || fg === "both")
      ctx.drawImage(tinted(edge, col, 1.0), 0, 0, cv.width, cv.height);
    ctx.imageSmoothingEnabled = true;
  }
  // 4. point markers for the displayed frame
  for (const o of OBJECTS){
    const pts = (POINTS[o.id] || {})[curFrame()] || [];
    for (const [x, y, label] of pts){
      const px = x / VW * cv.width, py = y / VH * cv.height;
      ctx.beginPath();
      ctx.arc(px, py, 6, 0, 2 * Math.PI);
      ctx.fillStyle = label ? colorOf(o.id) : "#000";
      ctx.fill();
      ctx.lineWidth = 2;
      ctx.strokeStyle = label ? "#fff" : "#ff3b30";
      ctx.stroke();
    }
  }
}
async function propagate(){
  if (!SID) return log("start a session first");
  log("tracking…");
  let n = 0, last = -1, shown = -1;
  // Drop the previous run's cached tracklets so a cancelled/failed
  // re-track can't leave frames beyond its progress showing stale masks
  // as if current; the stream re-delivers every frame it reaches. If it
  // dies before delivering anything, restore the old cache.
  const prevMasks = MASKS;
  MASKS = {};
  try {
    const r = await fetch("/propagate_in_video", {method: "POST",
      headers: {"Content-Type": "application/json"},
      body: JSON.stringify({session_id: SID})});
    const reader = r.body.getReader();
    const dec = new TextDecoder();
    let buf = "";
    for (;;){
      const {done, value} = await reader.read();
      if (done) break;
      buf += dec.decode(value, {stream: true});
      let nl;
      while ((nl = buf.indexOf("\n")) >= 0){
        const line = buf.slice(0, nl); buf = buf.slice(nl + 1);
        if (!line.trim()) continue;
        const item = JSON.parse(line);
        MASKS[item.frame_index] = item.results.map(x =>
          ({objectId: x.object_id, rleMask: x.mask}));
        last = item.frame_index;
        n++;
        if (n % 5 === 0){ seek(last); shown = last; }
      }
    }
    log(`tracking done: ${n} frames cached — scrub or play to review`);
  } catch (e) {
    if (n === 0) MASKS = prevMasks;
    log(`tracking failed after ${n} frames: ` + e);
  } finally {
    // show the last tracked frame even when the window ends off-stride
    // or the stream dies mid-way
    if (last >= 0 && last !== shown) seek(last);
  }
}
async function cancelProp(){
  await gql("mutation($i: CancelPropagateInVideoInput!) { " +
    "cancelPropagateInVideo(input: $i) { success } }", {i: {sessionId: SID}});
}
async function clearFrame(){
  const frameIndex = curFrame();
  for (const o of OBJECTS){
    await gql("mutation($i: ClearPointsInFrameInput!) { " +
      "clearPointsInFrame(input: $i) { success } }",
      {i: {sessionId: SID, frameIndex, objectId: o.id}});
    if (POINTS[o.id]) delete POINTS[o.id][frameIndex];
  }
  delete MASKS[frameIndex];
  render();
}
async function resetAll(){
  await gql("mutation($i: ClearPointsInVideoInput!) { " +
    "clearPointsInVideo(input: $i) { success } }", {i: {sessionId: SID}});
  POINTS = {}; MASKS = {};
  for (const o of OBJECTS) POINTS[o.id] = {};
  render();
}
async function closeSession(){
  if (!SID) return;
  if (PLAYING) togglePlay();
  await gql("mutation($i: CloseSessionInput!) { closeSession(input: $i) " +
    "{ success } }", {i: {sessionId: SID}});
  log("session closed"); SID = null;
}
</script>
</body>
</html>
"""
