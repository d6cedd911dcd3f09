#!/usr/bin/env python3
"""Image → fp16 .bin converter (quick loading for gigapixel fits;
format: int32 h, int32 w, h·w·4 float16 RGBA — matches the reference's
loader, ref: Testbed::load_binary_image)."""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngp_jax.data.image_io import read_image, save_binary_image


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output", default="")
    args = p.parse_args()
    try:
        from PIL import Image
        Image.MAX_IMAGE_PIXELS = 10_000_000_000
    except ImportError:
        pass
    img = read_image(args.input)
    print(f"{img.shape[1]}x{img.shape[0]} pixels, {img.shape[2]} channels")
    out = args.output or os.path.splitext(args.input)[0] + ".bin"
    save_binary_image(out, img)
    print("wrote", out)


if __name__ == "__main__":
    main()
