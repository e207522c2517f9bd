"""Offline render CLI — the app layer (reference: src/main.rs); port of
``tpurt/app/offline.py``.

Reproduces the reference application's default scene setup (main.rs:15-66):
a glTF model at 2x scale, one violet spot light and one red area light, a
pi/2 camera — then renders real-time frames or a progressively accumulated
ground-truth image, and writes PNGs. It renders on the card; ``--device
cpu`` asks for the host, and without a card and without it ``main``
raises.

Usage:
  python -m tpurt_torch.app.offline --model path.gltf [--width 800
      --height 800] [--frames 8] [--spp 64] [--out out.png]
      [--checkpoint accum.npz] [--quality low|medium|high|ultra]
      [--denoise 0..3] [--profile] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import math

import numpy as np

from ..engine import FrameTimer, Renderer, RendererConfig
from ..engine.accumulate import (accumulate_samples, init_accumulation,
                                 load_checkpoint, save_checkpoint)
from ..passes.encodings import pack_unorm8, srgb_approx
from ..passes.gtao import (QUALITY_HIGH, QUALITY_LOW, QUALITY_MEDIUM,
                           QUALITY_ULTRA, GtaoSettings)
from ..scene.lights import AreaLight, SpotLight

QUALITY = dict(low=QUALITY_LOW, medium=QUALITY_MEDIUM, high=QUALITY_HIGH,
               ultra=QUALITY_ULTRA)


def default_scene(renderer: Renderer, model_path: str):
    """The reference app's scene (main.rs:30-64): model at 2x scale,
    spot light + area light."""
    scale2 = np.array([[2.0, 0, 0, 0], [0, 2.0, 0, 0], [0, 0, 2.0, 0]],
                      np.float32)
    renderer.add_model(model_path, scale2)
    renderer.lights_mut().spot_lights.append(SpotLight(
        pos=[0.0, 1.5, 0.0], dir=[0.0, -1.0, 0.0],
        color=np.array([1.36, 0.16, 2.22]) * 10.0, falloff_distance=3.0,
        penumbra_umbra_angles=(math.radians(30.0), math.radians(45.0)),
        casts_shadows=True))
    renderer.lights_mut().area_lights.append(AreaLight(
        pos=[-0.70, 0.77, 0.08], pos2=[-0.70, 0.77, -0.16],
        pos3=[-0.70, 0.90, -0.16], invert_normal=False,
        color=np.array([1.96, 0.06, 0.41]) * 3.0, falloff_distance=3.0,
        penumbra_umbra_angles=(math.radians(90.0), math.radians(90.0)),
        casts_shadows=True))


def write_png(path: str, image_u8: np.ndarray):
    from PIL import Image

    Image.fromarray(np.asarray(image_u8), "RGB").save(path)


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cpu: the host)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=800)
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--spp", type=int, default=0,
                   help="accumulate this many samples (ground-truth mode)")
    p.add_argument("--out", default="frame.png")
    p.add_argument("--checkpoint", default=None,
                   help="accumulation checkpoint path (resume if it exists)")
    p.add_argument("--checkpoint-every", type=int, default=64)
    p.add_argument("--quality", choices=QUALITY, default="ultra")
    p.add_argument("--denoise", type=int, default=1)
    p.add_argument("--aa-spp", type=int, default=1,
                   help="anti-aliasing samples per pixel (real-time mode)")
    p.add_argument("--bent-normals", action="store_true",
                   help="enable GTAO's directional component")
    p.add_argument("--cam-pos", type=float, nargs=3, default=[0.0, 0.0, 0.0])
    p.add_argument("--cam-dir", type=float, nargs=3, default=[0.0, 0.0, 1.0])
    p.add_argument("--profile", action="store_true")
    add_device_arg(p)
    args = p.parse_args(argv)

    slices, steps = QUALITY[args.quality]
    cfg = RendererConfig(
        width=args.width, height=args.height,
        gtao=GtaoSettings(slice_count=int(slices), steps_per_slice=int(steps),
                          denoise=args.denoise,
                          bent_normals=args.bent_normals),
        spp=args.aa_spp, device=args.device)
    renderer = Renderer(cfg)
    default_scene(renderer, args.model)
    renderer.camera_mut().set_pos(args.cam_pos)
    renderer.camera_mut().set_dir(args.cam_dir)
    renderer.camera_mut().set_aspect(args.width / args.height)
    renderer.prepare_first_frame()

    if args.spp > 0:
        cam, lights, _ = renderer._frame_inputs()
        state = (load_checkpoint(args.checkpoint)
                 if args.checkpoint else None)
        if state is None:
            state = init_accumulation(args.height, args.width)
        while state.num_samples < args.spp:
            batch = min(args.checkpoint_every, args.spp - state.num_samples)
            state = accumulate_samples(state, renderer.scene_device, cam,
                                       lights, batch, width=args.width,
                                       height=args.height)
            if args.checkpoint:
                save_checkpoint(args.checkpoint, state)
            print(f"accumulated {state.num_samples}/{args.spp} spp")
        image = pack_unorm8(srgb_approx(state.mean)).cpu().numpy()
        write_png(args.out, image)
        print(f"wrote {args.out} ({state.num_samples} spp)")
        return

    timer = FrameTimer()
    image = None
    for _ in range(args.frames):
        image = renderer.render_image()
        timer.frame_end()
    write_png(args.out, image)
    print(f"wrote {args.out} ({args.frames} frames)")

    if args.profile:
        from ..engine.profiler import profile_frame

        stats = profile_frame(renderer, repeats=3)
        print(stats.pretty())


if __name__ == "__main__":
    main()
