"""Visualization helpers (reference ``utils/viz.{h,cc}``: colorizeDisparity /
overlayDisparity)."""
from __future__ import annotations

import numpy as np


def colorize_disparity(D: np.ndarray, min_d: float = 0.0,
                       max_d: float = None) -> np.ndarray:
    """float disparity -> BGR uint8 jet-style colorization; invalid (<=0) black
    (reference viz.cc colorizeDisparity)."""
    import cv2
    valid = D > min_d
    if max_d is None:
        max_d = float(D[valid].max()) if valid.any() else 1.0
    norm = np.zeros_like(D, np.float32)
    norm[valid] = np.clip((D[valid] - min_d) / max(max_d - min_d, 1e-6), 0, 1)
    u8 = (norm * 255).astype(np.uint8)
    color = cv2.applyColorMap(u8, cv2.COLORMAP_JET)
    color[~valid] = 0
    return color


def overlay_disparity(image: np.ndarray, D: np.ndarray,
                      alpha: float = 0.5) -> np.ndarray:
    """Blend colorized disparity over the grayscale image
    (reference viz.cc overlayDisparity)."""
    import cv2
    color = colorize_disparity(D)
    img_u8 = image.astype(np.uint8) if image.dtype != np.uint8 else image
    if img_u8.ndim == 2:
        img_u8 = cv2.cvtColor(img_u8, cv2.COLOR_GRAY2BGR)
    return cv2.addWeighted(img_u8, 1.0 - alpha, color, alpha, 0.0)


class Viewer:
    """Display-loop analogue of the reference VoApp viewer
    (apps/vo_app.cc:42-124): renders the current frame with the disparity
    overlay and a HUD line (frame #, Hz, KF marker).

    With a working GUI (cv2 window + $DISPLAY), keys mirror the reference:
    ``p`` pause, ``q``/ESC quit, ``d`` dump the current frame to PNG.
    Headless — the normal case on an accelerator host — every ``dump_every``-th
    rendered frame is written as a PNG under ``dump_dir`` instead, so the
    same run artifacts exist either way.
    """

    def __init__(self, name: str = "bpvo_tpu", dump_dir: str = None,
                 dump_every: int = 25):
        self._name = name
        self._dump_dir = dump_dir
        self._dump_every = max(1, dump_every)
        self._gui = None  # decided on first show()
        self._n = 0

    def _render(self, image, disparity, hz, is_keyframe):
        import cv2
        frame = overlay_disparity(np.asarray(image), np.asarray(disparity))
        hud = f"#{self._n}  {hz:5.1f} Hz" + ("  KF" if is_keyframe else "")
        cv2.putText(frame, hud, (8, 22), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                    (255, 255, 255), 1, cv2.LINE_AA)
        return frame

    def _dump(self, frame):
        import os
        import cv2
        if not self._dump_dir:
            return
        os.makedirs(self._dump_dir, exist_ok=True)
        cv2.imwrite(os.path.join(self._dump_dir,
                                 f"frame_{self._n:05d}.png"), frame)

    def show(self, image, disparity, hz: float = 0.0,
             is_keyframe: bool = False) -> bool:
        """Render one frame. Returns False when the user quit (GUI mode)."""
        import cv2
        frame = self._render(image, disparity, hz, is_keyframe)
        if self._gui is None:  # first call decides GUI vs headless
            # cv2.imshow ABORTS the process (Qt fatal) rather than raising in
            # a truly headless environment, so gate on $DISPLAY first and
            # only then probe the window backend
            import os
            self._gui = False
            if os.environ.get("DISPLAY"):
                try:
                    cv2.namedWindow(self._name, cv2.WINDOW_AUTOSIZE)
                    self._gui = True
                except cv2.error:
                    pass
        if self._gui:
            cv2.imshow(self._name, frame)
            k = cv2.waitKey(1) & 0xFF
            if k in (ord("q"), 27):
                return False
            if k == ord("d"):
                self._dump(frame)
            if k == ord("p"):  # pause until any key (vo_app.cc pause loop)
                while (cv2.waitKey(50) & 0xFF) == 0xFF:
                    pass
        elif self._n % self._dump_every == 0:
            self._dump(frame)
        self._n += 1
        return True

    def close(self):
        if self._gui:
            import cv2
            cv2.destroyWindow(self._name)
