"""The inputs and the pieces of the output check that a fault run leans on:
lit-target images are drawn from the pose and the seed, and a side that
took part of a batch has its dropout masks and discrete choices repeated
over the rows it left out, so the reference follows it on the rows both
hold."""
import torch

import checks
import sides

SCENE = {"kind": "scene", "background": [0, 90], "target": [40, 255], "tint": 0.25,
         "texture": 0.5, "body_radius": 0.22, "spot_radius": 0.05}


def pool(image, seed=11):
    recipe = sides.Recipe(torch, "detr_r50s8", "reference")
    return recipe.pool(seed, 2, 3, torch.device("cpu"), image)


def test_scene_images_follow_the_seed_and_the_pose():
    a, b, other = pool(SCENE), pool(SCENE), pool(SCENE, seed=12)
    assert a[0]["image"].dtype == torch.uint8 and a[0]["image"].shape == (3, 512, 512, 3)
    assert torch.equal(a[0]["image"], b[0]["image"])
    assert not torch.equal(a[0]["image"], other[0]["image"])
    level = a[0]["image"].float().mean((1, 2, 3))  # lit per image, not alike
    assert (level.max() - level.min()) > 5.0
    # the lighting is drawn after the pose: a pool's first batch has the poses,
    # boxes and landmarks of random pixels from the same seed
    noise = pool(None)
    for key in ("clip_bbox", "clip_bbox_buf", "landmarks_buf", "quat_gt", "tvec_gt"):
        assert torch.equal(noise[0][key], a[0][key])


def test_dropout_replay_repeats_masks_over_rows_left_out():
    x = torch.ones(4, 3, 6)
    mask = torch.rand(2, 3, 6) > 0.5
    replay = checks.DropoutReplay(torch, [((2, 3, 6), checks.pack_bits(torch, mask))],
                                  torch.device("cpu"))
    with replay:
        y = torch.nn.functional.dropout(x, 0.5, True)
    assert torch.equal(y, torch.cat([mask, mask]).float() * 2.0)
    assert checks.fitting_dim((2, 3, 6), (4, 3, 6)) == 0
    assert checks.fitting_dim((4, 3, 6), (4, 3, 6)) == -1
    assert checks.fitting_dim((2, 3, 5), (4, 3, 6)) is None


def test_followed_choices_repeat_over_rows_left_out():
    picked = torch.tensor([[2, 0, 1]])
    own = torch.zeros(3, 3, dtype=torch.long)
    assert torch.equal(checks.rows_like(picked, own), picked.repeat(3, 1))
    assert checks.rows_like(own, own) is own
