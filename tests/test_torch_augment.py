"""The port's point-set augmentations against the JAX package's, on the CPU.

Each of the eight functions of ``patchaugnet_tpu_torch.data.augment`` on
the same input, once from a ``np.random.RandomState`` of one seed on
each side and once from the global ``np.random`` stream seeded alike
(``rng=None``): the outputs are bit-equal, and so is the state each
generator is left in (the same numbers were drawn).
"""
import numpy as np
import pytest

from patchaugnet_tpu.data import augment as jaug

from patchaugnet_tpu_torch.data import augment as paug

CASES = {
    "jitter_points": lambda m, c, rng: m.jitter_points(c, sigma=0.01, rng=rng),
    "jitter_points clipped, p 0.6": lambda m, c, rng: m.jitter_points(c, sigma=0.05, clip=0.02, p=0.6, rng=rng),
    "remove_random_points": lambda m, c, rng: m.remove_random_points(c, r=0.3, rng=rng),
    "remove_random_points ranged": lambda m, c, rng: m.remove_random_points(c, r=(0.0, 0.5), rng=rng),
    "remove_random_block": lambda m, c, rng: m.remove_random_block(c, p=1.0, rng=rng),
    "random_translation": lambda m, c, rng: m.random_translation(c, max_delta=0.1, rng=rng),
    "random_rotation": lambda m, c, rng: m.random_rotation(c, rng=rng),
    "random_rotation about z, no wobble": lambda m, c, rng: m.random_rotation(
        c, axis=np.array([0.0, 0.0, 1.0]), max_theta=30, max_theta2=None, rng=rng),
    "random_flip": lambda m, c, rng: m.random_flip(c, [0.3, 0.3, 0.4], rng=rng),
    "train_transform": lambda m, c, rng: m.train_transform(c, rng=rng),
    "train_set_transform": lambda m, c, rng: m.train_set_transform(c, rng=rng),
}


def _cloud(shape=(256, 3)):
    return (np.random.RandomState(8).rand(*shape) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("stream", ["RandomState", "global"])
@pytest.mark.parametrize("case", list(CASES))
def test_bit_equal_to_the_jax_package(case, stream):
    fn = CASES[case]
    outs, states = [], []
    for mod in (jaug, paug):
        cloud = _cloud((4, 256, 3) if case == "train_set_transform" else (256, 3))
        if stream == "global":
            np.random.seed(21)
            rng = None
        else:
            rng = np.random.RandomState(21)
        outs.append(fn(mod, cloud, rng))
        states.append((rng or np.random).get_state()[1].copy())
        np.testing.assert_array_equal(cloud, _cloud(cloud.shape))          # the input is left as it was
    assert outs[0].dtype == outs[1].dtype and outs[0].shape == outs[1].shape
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(states[0], states[1])
    assert not np.array_equal(outs[1], _cloud(outs[1].shape))


def test_invalid_arguments_raise():
    with pytest.raises(ValueError):
        paug.jitter_points(_cloud(), sigma=0.0)
    with pytest.raises(ValueError):
        paug.random_flip(_cloud(), [0.5, 0.5, 0.5])
