"""vo: the main CLI binary (counterpart of reference ``apps/vo.cc``:
config / output / numframes / buffersize / points / store-timing flags driving
VoApp, vo.cc:42-68).

Usage: python -m bpvo_tpu.apps.vo --config conf/file.cfg [--output prefix]
       [--numframes N] [--buffersize B] [--points] [--dontstoretiming]
"""
from __future__ import annotations

import argparse

from bpvo_tpu.apps.vo_app import VoApp, VoAppOptions
from bpvo_tpu.utils import debug


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", "-c", default="../conf/tsukuba.cfg",
                    help="config file")
    ap.add_argument("--output", "-o", default="output",
                    help="trajectory/timing output prefix")
    ap.add_argument("--numframes", "-n", type=int, default=-1,
                    help="number of frames to process")
    ap.add_argument("--buffersize", "-b", type=int, default=16,
                    help="loader readahead buffer size")
    ap.add_argument("--points", action="store_true",
                    help="store point clouds (PLY) at keyframes")
    ap.add_argument("--dontstoretiming", action="store_true")
    ap.add_argument("--viewer", "-v", action="store_true",
                    help="display loop (GUI if available, else PNG dumps "
                         "under <output>_frames/)")
    args = ap.parse_args()
    from bpvo_tpu.utils.device import enable_compile_cache
    enable_compile_cache()

    app = VoApp.from_config(
        args.config,
        trajectory_prefix=args.output,
        points_prefix=args.output if args.points else "",
        data_buffer_size=args.buffersize,
        max_num_frames=args.numframes,
        store_iteration_time=not args.dontstoretiming,
        viewer=args.viewer)
    result = app.run()
    debug.info("done: %d frames @ %.2f Hz", result.num_frames, result.mean_hz)


if __name__ == "__main__":
    main()
