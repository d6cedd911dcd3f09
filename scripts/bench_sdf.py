#!/usr/bin/env python3
"""SDF acceptance benchmark: train a bundled mesh and report IoU
(ref metric: Testbed::calculate_iou, src/testbed_sdf.cu:1269).

    python scripts/bench_sdf.py --mesh /root/reference/data/sdf/armadillo.obj \
        --n_steps 2000 [--iou_samples 2097152]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="/root/reference/data/sdf/armadillo.obj")
    p.add_argument("--config", default="configs/sdf/base.json")
    p.add_argument("--n_steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=1 << 18)
    p.add_argument("--iou_samples", type=int, default=1 << 21)
    p.add_argument("--eval_every", type=int, default=500)
    p.add_argument("--octree_uniform", action="store_true")
    p.add_argument("--sign_mode", default="watertight",
                   choices=["watertight", "raystab"],
                   help="raystab fires ~32 ray probes per query (ref "
                        "default, robust to open meshes) — on the host "
                        "BVH that is 5-10 s per 2^18 batch; closed "
                        "meshes like armadillo use watertight (1 "
                        "closest-point query)")
    args = p.parse_args()

    from ngp_jax.config import load_network_config
    from ngp_jax.train.sdf import SdfTrainer

    t0 = time.time()
    cfg = load_network_config(args.config)
    from ngp_jax.data.mesh import TriangleBvh
    mode = (TriangleBvh.MODE_WATERTIGHT if args.sign_mode == "watertight"
            else TriangleBvh.MODE_RAYSTAB)
    tr = SdfTrainer(args.mesh, cfg, batch_size=args.batch, sign_mode=mode,
                    use_octree_uniform=args.octree_uniform or None)
    print(f"init (mesh+BVH) {time.time() - t0:.1f}s  "
          f"{len(tr.faces)} tris", flush=True)

    done = 0
    t_train = 0.0
    while done < args.n_steps:
        k = min(args.eval_every, args.n_steps - done)
        ts = time.time()
        loss = tr.train(k)
        t_train += time.time() - ts
        done += k
        ti = time.time()
        iou = tr.calculate_iou(n_samples=args.iou_samples)
        print(f"step {done}: loss={loss:.5f} train_s={t_train:.1f} "
              f"IoU={iou:.4f} (eval {time.time() - ti:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
