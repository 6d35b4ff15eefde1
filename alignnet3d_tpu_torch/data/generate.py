"""Dataset-generation CLI for the synthetic family.

Counterpart of ``alignnet3d_tpu/data/generate.py``, with the same variants,
flags and defaults, over the port's own ``data/synthetic.py`` and
``data/mesh_raycast.py``:

    python -m alignnet3d_tpu_torch.data.generate SynthCars --out data/SynthCars
    python -m alignnet3d_tpu_torch.data.generate SynthCarsPersons --out data/...
    python -m alignnet3d_tpu_torch.data.generate Synth20 --out data/Synth20
    python -m alignnet3d_tpu_torch.data.generate Synth20others --out data/...
    python -m alignnet3d_tpu_torch.data.generate SynthCarsMesh --out data/...

Variant semantics follow the reference's dataset family
(reference README.md:40-43, pointcloud.py:1055-1087):
- SynthCars: cars only, first shape set;
- SynthCarsPersons: 20% persons mixed in;
- Synth20: smaller 20-scene-per-object style mixed set, first shape set;
- Synth20others: same distribution drawn from the HELD-OUT shape set
  (second_object_set), the transfer-learning target of Synth20;
- SynthCarsMesh: procedural car meshes scanned by the port's BVH raycaster
  (``csrc/raycast.cpp``, built by g++ at first use).
"""

from __future__ import annotations

import argparse

from alignnet3d_tpu_torch.data.synthetic import generate_dataset

VARIANTS = {
    "SynthCars": dict(allow_persons=False, second_object_set=False),
    "SynthCarsPersons": dict(allow_persons=True, second_object_set=False),
    "Synth20": dict(allow_persons=True, second_object_set=False),
    "Synth20others": dict(allow_persons=True, second_object_set=True),
    # mesh-raycast variant: procedural car meshes through the native BVH
    # (the reference's Embree pipeline, pointcloud.py:1119-1138)
    "SynthCarsMesh": dict(),
}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("variant", choices=sorted(VARIANTS))
    parser.add_argument("--out", required=True, help="output dataset dir")
    parser.add_argument("--num_train", type=int, default=8000)
    parser.add_argument("--num_val", type=int, default=1200)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vres", type=int, default=64)
    parser.add_argument("--hres", type=int, default=1500)
    args = parser.parse_args(argv)

    kwargs = VARIANTS[args.variant]
    if args.variant == "SynthCarsMesh":
        from alignnet3d_tpu_torch.data.mesh_raycast import generate_mesh_dataset

        train_idx, val_idx = generate_mesh_dataset(
            args.out, num_train=args.num_train, num_val=args.num_val,
            seed=args.seed, vres=args.vres, hres=args.hres,
        )
    else:
        train_idx, val_idx = generate_dataset(
            args.out, num_train=args.num_train, num_val=args.num_val,
            seed=args.seed, vres=args.vres, hres=args.hres, **kwargs,
        )
    print(f"{args.variant}: wrote {len(train_idx)} train / "
          f"{len(val_idx)} val scenes to {args.out}")


if __name__ == "__main__":
    main()
