"""VideoPostProcessor: billiards event detection over segmentation masks.

Counterpart of the JAX package's ``app/postprocess.py`` (Det-SAM2's
postprocess_det_sam2.py): map pocket detections to named holes, derive the
effective table boundary, compute per-frame ball centroids (with the white
ball's mask subtracted) and velocities (with <= 5-frame backtracking), then
detect three events:

  * pot       - a ball disappears near a hole while moving toward it;
  * collision - velocity jump + proximity + approaching-before /
                separating-after relative-velocity test;
  * rebound   - buffer-zone membership + toward / away motion + vertical
                component reversal or parallel component conservation, with
                a near-hole arc fallback.

Host numpy only (it runs on the pipeline's postprocess thread, which never
touches the card); cv2 is imported only to draw the overlay. Frame indices
are video-relative (the processor removes the preload offset).
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("cv2 required for visualization") from e
    return cv2

# canonical 1920x1080 hole anchors (postprocess_det_sam2.py:240-242)
DEFAULT_HOLE_ANCHORS = {
    "left_up": (100, 100),
    "middle_up": (960, 0),
    "right_up": (1820, 100),
    "left_down": (100, 720),
    "middle_down": (960, 720),
    "right_down": (1820, 720),
}

WHITE_BALL_ID = 16


class VideoPostProcessor:
    def __init__(
        self,
        pot_distance_threshold: float = 100.0,
        pot_velocity_threshold: float = 0.9,
        ball_distance_threshold: float = 120.0,
        ball_velocity_threshold: float = 10.0,
        table_margin: float = 100.0,
        rebound_velocity_threshold: float = 0.7,
        hole_anchors: Optional[Dict[str, Tuple[float, float]]] = None,
        white_ball_id: int = WHITE_BALL_ID,
    ):
        self.pot_distance_threshold = pot_distance_threshold
        self.pot_velocity_threshold = pot_velocity_threshold
        self.ball_distance_threshold = ball_distance_threshold
        self.ball_velocity_threshold = ball_velocity_threshold
        self.margin = table_margin
        self.rebound_velocity_threshold = rebound_velocity_threshold
        self.hole_anchors = dict(hole_anchors or DEFAULT_HOLE_ANCHORS)
        self.white_ball_id = white_ball_id
        self.clear()

    def clear(self) -> None:
        self.hole_names_and_positions: List[Tuple[str, Tuple[float, float]]] = []
        self.effective_boundary = None
        self.balls_positions: Dict[int, Dict[int, Optional[tuple]]] = {}
        self.balls_velocities: Dict[int, Dict[int, tuple]] = {}
        self.disappeared_balls: Dict[int, dict] = {}  # pot events
        self.ball_collision: Dict[int, list] = {}
        self.ball_rebound: Dict[int, list] = {}

    # ------------------------------------------------------------------
    # table geometry
    # ------------------------------------------------------------------

    def get_hole_name(self, pockets) -> None:
        """Assign each detected pocket box to the nearest named hole
        (:237-275). pockets: path to a pickle or a list of xyxy boxes."""
        if isinstance(pockets, str):
            with open(pockets, "rb") as f:
                pockets = pickle.load(f)
        if pockets is None:
            return
        for box in pockets:
            cx = (box[0] + box[2]) / 2.0
            cy = (box[1] + box[3]) / 2.0
            best, best_d = None, np.inf
            for name, anchor in self.hole_anchors.items():
                d = float(np.hypot(cx - anchor[0], cy - anchor[1]))
                if d < best_d:
                    best, best_d = name, d
            if best is not None:
                self.hole_names_and_positions.append((best, (cx, cy)))

    def get_boundary_from_holes(self) -> None:
        """Table boundary from the 4 corner holes -/+ margin (:277-298)."""
        if not self.hole_names_and_positions:
            raise ValueError("no hole positions available to define boundaries")
        pos = {name: p for name, p in self.hole_names_and_positions}
        lu, ru = pos["left_up"], pos["right_up"]
        ld, rd = pos["left_down"], pos["right_down"]
        left = min(lu[0], ld[0]) + self.margin
        right = max(ru[0], rd[0]) - self.margin
        top = min(lu[1], ru[1]) + self.margin
        bottom = max(ld[1], rd[1]) - self.margin
        self.effective_boundary = (left, right, top, bottom)

    # ------------------------------------------------------------------
    # positions / velocities
    # ------------------------------------------------------------------

    @staticmethod
    def _squeeze(mask: np.ndarray) -> np.ndarray:
        m = np.asarray(mask)
        while m.ndim > 2:
            m = m[0]
        return m

    def remove_white_ball_from_other_masks(
        self, white_mask, other_masks, dilation_iterations: int = 1
    ):
        """Subtract a dilated white-ball mask from other balls' masks
        (:302-329)."""
        w = self._squeeze(white_mask).astype(np.uint8)
        # 3x3 dilation (cv2.dilate with a 3x3 kernel: its border value is
        # the identity of max, as the zero padding is here)
        for _ in range(dilation_iterations):
            p = np.pad(w, 1)
            w = np.max(
                np.stack(
                    [
                        p[i : i + w.shape[0], j : j + w.shape[1]]
                        for i in range(3)
                        for j in range(3)
                    ]
                ),
                axis=0,
            )
        out = []
        for m in other_masks:
            m = self._squeeze(m).astype(np.uint8)
            out.append((m & (1 - w)).astype(np.uint8))
        return out

    def get_position(self, mask) -> Optional[Tuple[int, int]]:
        """Centroid of a binary mask via moments (:331-343)."""
        m = self._squeeze(mask)
        ys, xs = np.nonzero(m)
        if len(xs) == 0:
            return None
        return (int(xs.mean()), int(ys.mean()))

    def process_frame_positions(self, frame_segments: Dict[int, np.ndarray]):
        """Per-ball centroids with white-ball subtraction (:345-360)."""
        positions = {}
        white = frame_segments.get(self.white_ball_id)
        for ball_id, mask in frame_segments.items():
            if ball_id != self.white_ball_id and white is not None:
                mask = self.remove_white_ball_from_other_masks(white, [mask])[0]
            positions[ball_id] = self.get_position(mask)
        return positions

    def process_frame_velocities(
        self, frame_idx: int, time_interval: float = 1.0, max_backtrack: int = 5
    ):
        """Velocity vectors with <=max_backtrack-frame position backtracking
        (:370-402)."""
        velocities = {}
        current = self.balls_positions[frame_idx]
        for ball_id, pos in current.items():
            prev, dt = None, time_interval
            for back in range(1, max_backtrack + 1):
                pframe = frame_idx - back
                if pframe in self.balls_positions:
                    prev = self.balls_positions[pframe].get(ball_id)
                    if prev is not None:
                        dt = time_interval * back
                        break
            if prev is None or pos is None:
                velocities[ball_id] = (0.0, 0.0)
            else:
                velocities[ball_id] = (
                    (pos[0] - prev[0]) / dt,
                    (pos[1] - prev[1]) / dt,
                )
        return velocities

    # ------------------------------------------------------------------
    # pot
    # ------------------------------------------------------------------

    def is_near_hole(self, position, hole_position):
        if position is None:
            return False, None
        d = float(np.hypot(position[0] - hole_position[0],
                           position[1] - hole_position[1]))
        return d < self.pot_distance_threshold, d

    def is_velocity_towards_hole(self, ball_id, position, frame_idx) -> bool:
        # frame_idx-1 has no velocities when the ball disappears at frame 1
        # (velocities start at frame 1); Det-SAM2 raises KeyError here —
        # treat "no velocity yet" as not-towards-hole instead
        v = self.balls_velocities.get(frame_idx - 1, {}).get(ball_id)
        if not v or (v[0] == 0 and v[1] == 0):
            return False
        vn = np.asarray(v, float)
        vn = vn / np.linalg.norm(vn)
        for _, hole_pos in self.hole_names_and_positions:
            hv = np.asarray(hole_pos, float) - np.asarray(position, float)
            n = np.linalg.norm(hv)
            if n == 0:
                continue
            if float(np.dot(hv / n, vn)) > self.pot_velocity_threshold:
                return True
        return False

    def check_ball_disappeared_pot(self, frame_idx: int) -> None:
        current = self.balls_positions[frame_idx]
        previous = self.balls_positions[frame_idx - 1]
        for ball_id, prev_pos in previous.items():
            if current.get(ball_id) is not None:
                continue
            for hole_name, hole_pos in self.hole_names_and_positions:
                near, _ = self.is_near_hole(prev_pos, hole_pos)
                if near and self.is_velocity_towards_hole(
                    ball_id, prev_pos, frame_idx
                ):
                    self.disappeared_balls[ball_id] = {
                        "last_frame": frame_idx - 1,
                        "last_position": prev_pos,
                        "hole": hole_name,
                    }

    # ------------------------------------------------------------------
    # collision
    # ------------------------------------------------------------------

    @staticmethod
    def get_velocity_change(v, pv) -> float:
        return float(np.hypot(v[0] - pv[0], v[1] - pv[1]))

    @staticmethod
    def is_moving_towards(v1, v2, p1, p2) -> bool:
        if p1 is None or p2 is None or v1 is None or v2 is None:
            return False
        rel_v = np.asarray(v1, float) - np.asarray(v2, float)
        rel_p = np.asarray(p1, float) - np.asarray(p2, float)
        return float(np.dot(rel_v, rel_p)) < 0

    def is_valid_collision(self, pv1, pv2, pp1, pp2, cv1, cv2_) -> bool:
        if not self.is_moving_towards(pv1, pv2, pp1, pp2):
            return False
        if cv1 is None or cv2_ is None:
            return False
        prev_rel = np.asarray(pv1, float) - np.asarray(pv2, float)
        curr_rel = np.asarray(cv1, float) - np.asarray(cv2_, float)
        return float(np.dot(prev_rel, curr_rel)) < 0

    def find_potential_collisions(self, ball_id, frame_idx) -> List[int]:
        out = []
        prev_pos = self.balls_positions[frame_idx - 1].get(ball_id)
        cur_pos = self.balls_positions[frame_idx].get(ball_id)
        prev_v = self.balls_velocities[frame_idx - 1].get(ball_id)
        cur_v = self.balls_velocities[frame_idx].get(ball_id)
        if cur_pos is None:
            return out
        for other_id, other_pos in self.balls_positions[frame_idx].items():
            if other_id == ball_id or other_pos is None:
                continue
            d = float(np.hypot(cur_pos[0] - other_pos[0],
                               cur_pos[1] - other_pos[1]))
            if d >= self.ball_distance_threshold:
                continue
            if self.is_valid_collision(
                prev_v,
                self.balls_velocities[frame_idx - 1].get(other_id),
                prev_pos,
                self.balls_positions[frame_idx - 1].get(other_id),
                cur_v,
                self.balls_velocities[frame_idx].get(other_id),
            ):
                out.append(other_id)
        return out

    def check_ball_collision(self, frame_idx: int) -> None:
        collisions = []
        for ball_id, v in self.balls_velocities[frame_idx].items():
            pv = self.balls_velocities[frame_idx - 1].get(ball_id, (0, 0))
            if self.get_velocity_change(v, pv) > self.ball_velocity_threshold:
                for other_id in self.find_potential_collisions(ball_id, frame_idx):
                    collisions.append((ball_id, other_id))
        self.ball_collision[frame_idx] = collisions

    # ------------------------------------------------------------------
    # rebound
    # ------------------------------------------------------------------

    def is_in_buffer_zone(self, x, y) -> Optional[str]:
        lb, rb, tb, bb = self.effective_boundary
        left, right = lb - self.margin, rb + self.margin
        top, bottom = tb - self.margin, bb + self.margin
        if lb > x > left or rb < x < right or tb > y > top or bb < y < bottom:
            distances = {
                "left": abs(x - lb),
                "right": abs(x - rb),
                "top": abs(y - tb),
                "bottom": abs(y - bb),
            }
            return min(distances, key=distances.get)
        return None

    def _vertical_velocity_reversed(self, boundary, vx, vy, pvx, pvy) -> bool:
        t = self.rebound_velocity_threshold
        if boundary in ("left", "right"):
            return (1 - t) * abs(vx) < abs(pvx) < (1 + t) * abs(vx)
        if boundary in ("top", "bottom"):
            return (1 - t) * abs(vy) < abs(pvy) < (1 + t) * abs(vy)
        return False

    def _parallel_velocity_same(self, boundary, vx, vy, pvx, pvy) -> bool:
        t = self.rebound_velocity_threshold
        if boundary in ("left", "right"):
            return abs((1 - t) * pvy) < abs(vy) < abs(1.1 * pvy)
        if boundary in ("top", "bottom"):
            return abs((1 - t) * pvx) < abs(vx) < abs(1.1 * pvx)
        return False

    def is_near_the_hole_and_rebound(
        self, cur_pos, prev_pos, v, pv, ball_id, frame_idx
    ):
        """Near-hole arc fallback (:694-794); mirrors Det-SAM2's
        first-hole-only evaluation order."""
        for hole_name, hole_pos in self.hole_names_and_positions:
            near, _ = self.is_near_hole(cur_pos, hole_pos)
            if not near:
                return False, None
            if self.get_velocity_change(v, pv) <= self.ball_velocity_threshold:
                return False, None
            moving_towards_other = False
            for other_id, p_other in self.balls_positions[frame_idx - 1].items():
                if other_id == ball_id or p_other is None or prev_pos is None:
                    continue
                d = float(np.hypot(prev_pos[0] - p_other[0],
                                   prev_pos[1] - p_other[1]))
                if d < self.ball_distance_threshold:
                    pv_other = self.balls_velocities[frame_idx - 1].get(other_id)
                    moving_towards_other = self.is_moving_towards(
                        pv, pv_other, prev_pos, p_other
                    )
            if moving_towards_other:
                collisions = self.ball_collision.get(frame_idx) or []
                if ball_id in [a for a, _ in collisions]:
                    return False, None
                return True, hole_name
            return True, hole_name
        return False, None

    def check_ball_rebound(self, frame_idx: int) -> None:
        current = self.balls_positions[frame_idx]
        previous = self.balls_positions[frame_idx - 1]
        velocities = self.balls_velocities[frame_idx]
        prev_velocities = self.balls_velocities[frame_idx - 1]
        rebounded = []
        for ball_id, cur_pos in current.items():
            prev_pos = previous.get(ball_id)
            v = velocities.get(ball_id)
            pv = prev_velocities.get(ball_id)
            if cur_pos is None or prev_pos is None or v is None or pv is None:
                continue
            bz_cur = self.is_in_buffer_zone(*cur_pos)
            bz_prev = self.is_in_buffer_zone(*prev_pos)
            boundary = bz_cur if (bz_cur and bz_prev) else None
            if not boundary:
                continue
            towards = (
                (boundary == "left" and pv[0] < 0)
                or (boundary == "right" and pv[0] > 0)
                or (boundary == "top" and pv[1] < 0)
                or (boundary == "bottom" and pv[1] > 0)
            )
            away = (
                (boundary == "left" and v[0] > 0)
                or (boundary == "right" and v[0] < 0)
                or (boundary == "top" and v[1] > 0)
                or (boundary == "bottom" and v[1] < 0)
            )
            if not (towards and away):
                continue
            if self._vertical_velocity_reversed(boundary, v[0], v[1], pv[0], pv[1]):
                rebounded.append((ball_id, boundary))
            elif self._parallel_velocity_same(boundary, v[0], v[1], pv[0], pv[1]):
                rebounded.append((ball_id, boundary))
            else:
                ok, _ = self.is_near_the_hole_and_rebound(
                    cur_pos, prev_pos, v, pv, ball_id, frame_idx
                )
                if ok:
                    rebounded.append((ball_id, boundary))
        self.ball_rebound[frame_idx] = rebounded

    # ------------------------------------------------------------------
    # running over a video
    # ------------------------------------------------------------------

    def load_video_segments(self, file_path: str):
        with open(file_path, "rb") as f:
            payload = pickle.load(f)
        if isinstance(payload, dict) and "video_segments" in payload:
            return payload["video_segments"]
        return payload

    def process_single_frame(self, frame_idx: int, segments, time_interval=1.0):
        """Incremental per-frame processing (used by the async pipeline)."""
        self.balls_positions[frame_idx] = self.process_frame_positions(segments)
        if frame_idx > 0 and (frame_idx - 1) in self.balls_positions:
            self.balls_velocities[frame_idx] = self.process_frame_velocities(
                frame_idx, time_interval
            )
            self.check_ball_disappeared_pot(frame_idx)
            if frame_idx > 1 and (frame_idx - 1) in self.balls_velocities:
                self.check_ball_collision(frame_idx)
                self.check_ball_rebound(frame_idx)

    def run(self, video_segments, time_interval: float = 1.0) -> None:
        """Full-video postprocess (:798-821). video_segments: dict or a
        pickle path."""
        if isinstance(video_segments, str):
            video_segments = self.load_video_segments(video_segments)
        for frame_idx, segments in sorted(video_segments.items()):
            self.process_single_frame(frame_idx, segments, time_interval)

    # ------------------------------------------------------------------

    def events(self) -> Dict[str, list]:
        """Summarize detected events for evaluation."""
        pots = [
            {"ball": bid, "frame": info["last_frame"], "hole": info["hole"]}
            for bid, info in self.disappeared_balls.items()
        ]
        collisions = [
            {"frame": f, "balls": pair}
            for f, pairs in self.ball_collision.items()
            for pair in pairs
        ]
        rebounds = [
            {"frame": f, "ball": bid, "boundary": b}
            for f, items in self.ball_rebound.items()
            for bid, b in items
        ]
        return {"pot": pots, "collision": collisions, "rebound": rebounds}

    # ------------------------------------------------------------------
    # event-overlay visualization (postprocess_det_sam2.py:61-232)
    # ------------------------------------------------------------------

    def draw_frame_overlay(self, frame_bgr: np.ndarray, frame_idx: int,
                           total_frames: int) -> np.ndarray:
        """Draw detected-event annotations for one frame (BGR, in place):
        hole anchors + pot-threshold circles + names, ball centroids with
        velocity arrows and ids, pot rings + "<id> In <hole>" labels (shown
        for 10 frames after the pot), collision rings + a bottom-center
        caption, table-boundary rectangles with the rebound edge highlighted
        + the rebounding ball id, and a frame counter."""
        cv2 = _cv2()
        h, w = frame_bgr.shape[:2]
        red, green, white = (0, 0, 255), (0, 255, 0), (255, 255, 255)

        for hole_name, hole_center in self.hole_names_and_positions:
            c = tuple(int(v) for v in hole_center)
            cv2.circle(frame_bgr, c, 10, red, -1)
            cv2.circle(frame_bgr, c, int(self.pot_distance_threshold), green, 2)
            cv2.putText(frame_bgr, hole_name, (c[0] + 15, c[1] + 15),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, white, 2)

        positions = self.balls_positions.get(frame_idx, {})
        velocities = self.balls_velocities.get(frame_idx, {})
        for ball_id, pos in positions.items():
            if pos is None:
                continue
            p = tuple(int(v) for v in pos)
            cv2.circle(frame_bgr, p, 8, red, -1)
            vx, vy = velocities.get(ball_id, (0, 0))
            cv2.arrowedLine(frame_bgr, p, (int(p[0] + vx), int(p[1] + vy)),
                            red, 4, tipLength=0.1)
            cv2.putText(frame_bgr, str(ball_id), (p[0] + 10, p[1] - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.6, white, 2)

        for ball_id, info in self.disappeared_balls.items():
            last = info["last_frame"]
            if last <= frame_idx <= last + 10:
                x, y = (int(v) for v in info["last_position"])
                cv2.circle(frame_bgr, (x, y), 10, red, 3)
                cv2.putText(frame_bgr, f"{ball_id} In {info['hole']}",
                            (x + 10, y), cv2.FONT_HERSHEY_SIMPLEX, 0.7, red, 2)

        pairs = self.ball_collision.get(frame_idx, [])
        if pairs:
            for id1, id2 in pairs:
                for bid in (id1, id2):
                    pos = positions.get(bid)
                    if pos is not None:
                        cv2.circle(frame_bgr, tuple(int(v) for v in pos),
                                   25, red, 3)
            caption = f"{frame_idx} frame collisions: " + ", ".join(
                f"Ball {a} & Ball {b}" for a, b in pairs
            )
            (tw, _), _ = cv2.getTextSize(
                caption, cv2.FONT_HERSHEY_SIMPLEX, 1, 2
            )
            cv2.putText(frame_bgr, caption, ((w - tw) // 2, h - 10),
                        cv2.FONT_HERSHEY_SIMPLEX, 1, white, 2)

        if self.effective_boundary is not None:
            lb, rb, tb, bb = (int(v) for v in self.effective_boundary)
            m = int(self.margin)
            outer = (lb - m, tb - m, rb + m, bb + m)
            cv2.rectangle(frame_bgr, (outer[0], outer[1]),
                          (outer[2], outer[3]), green, 2)
            cv2.rectangle(frame_bgr, (lb, tb), (rb, bb), green, 2)
            edges = {
                "top": ((outer[0], outer[1], outer[2], outer[1]),
                        (lb, tb, rb, tb), ((lb + rb) // 2, tb + 20)),
                "bottom": ((outer[0], outer[3], outer[2], outer[3]),
                           (lb, bb, rb, bb), ((lb + rb) // 2, bb - 10)),
                "left": ((outer[0], outer[1], outer[0], outer[3]),
                         (lb, tb, lb, bb), (lb + 10, (tb + bb) // 2)),
                "right": ((outer[2], outer[1], outer[2], outer[3]),
                          (rb, tb, rb, bb), (rb - 50, (tb + bb) // 2)),
            }
            for ball_id, direction in self.ball_rebound.get(frame_idx, []):
                if direction not in edges:
                    continue
                o, inner, txt = edges[direction]
                cv2.line(frame_bgr, (o[0], o[1]), (o[2], o[3]), red, 2)
                cv2.line(frame_bgr, (inner[0], inner[1]),
                         (inner[2], inner[3]), red, 2)
                cv2.putText(frame_bgr, str(ball_id), txt,
                            cv2.FONT_HERSHEY_SIMPLEX, 1.5, white, 3)

        cv2.putText(frame_bgr, f"Frame: {frame_idx + 1}/{total_frames}",
                    (10, 30), cv2.FONT_HERSHEY_SIMPLEX, 1, white, 2)
        return frame_bgr

    def visualize(self, video_source, output_video_dir: str,
                  output_video_name: str = "postprocess_visualized.mp4",
                  fps: int = 2) -> str:
        """Render the event overlay onto every frame and write an mp4
        (Det-SAM2's visualize(): local video path OR a list of RGB frames;
        output at 2 fps). Returns the written path."""
        cv2 = _cv2()
        import os

        os.makedirs(output_video_dir, exist_ok=True)
        out_path = os.path.join(output_video_dir, output_video_name)

        cap = None
        if isinstance(video_source, str):
            if not os.path.isfile(video_source):
                raise FileNotFoundError(video_source)
            cap = cv2.VideoCapture(video_source)
            width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        else:
            total = len(video_source)
            height, width = video_source[0].shape[:2]

        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
        try:
            for frame_idx in range(total):
                if cap is not None:
                    ok, frame = cap.read()
                    if not ok:
                        break
                else:
                    frame = cv2.cvtColor(
                        np.ascontiguousarray(video_source[frame_idx]),
                        cv2.COLOR_RGB2BGR,
                    )
                writer.write(
                    self.draw_frame_overlay(frame, frame_idx, total)
                )
        finally:
            if cap is not None:
                cap.release()
            writer.release()
        return out_path
