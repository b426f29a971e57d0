_base_ = ["./semseg-spunet-r3.py"]
# Test-time evaluation of the committed semseg checkpoint (exp/semseg_r3) with
# the ScanNet recipe's test_cfg shape (configs/scannet/semseg-spunet-v1m1-0-base.py):
# GridSample test-mode fragments at the r3 grid (0.05) under 3 RandomScale
# variants, the scene kept at its GridSample train-mode voxels with Copy and
# inverse, and the synthetic recipe's features (coord, color).

weight = "exp/semseg_r3/model_params.ckpt"
test = dict(type="SemSegTester", fragment_capacity=16384)  # a scene's fragments hold up to ~12,000 points

data = dict(
    test=dict(
        type="SyntheticSemSegDataset",
        split="val",
        num_scenes=8,
        num_points=16000,
        num_classes=6,
        test_mode=True,
        transform=[
            dict(type="CenterShift", apply_z=True),
            dict(type="NormalizeColor"),
            dict(type="Copy", keys_dict=dict(segment="origin_segment")),
            dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="train",
                 return_inverse=True, return_grid_coord=True),
        ],
        test_cfg=dict(
            voxelize=dict(type="GridSample", grid_size=0.05, hash_type="fnv", mode="test",
                          return_grid_coord=True),
            crop=None,
            post_transform=[
                dict(type="CenterShift", apply_z=False),
                dict(type="Collect", keys=("coord", "grid_coord", "index"), feat_keys=("coord", "color")),
            ],
            aug_transform=[[dict(type="RandomScale", scale=[0.9, 0.9])],
                           [dict(type="RandomScale", scale=[1.0, 1.0])],
                           [dict(type="RandomScale", scale=[1.1, 1.1])]],
        ),
    ),
)
