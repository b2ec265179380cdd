"""The inputs repeat from a seed, and differ between seeds."""

import torch

from portbench import common, run


def test_apply_vector_repeats_from_a_seed_and_differs_between_seeds():
    def draw(seed):
        ctx, _, _, _, loop = run.make_ctx("hpcg_spmv", seed, "cpu",
                                          {"nx": 4, "ny": 4, "nz": 4})
        ctx.stats["cols"] = 64
        return loop.draw_x(ctx)

    big = 2**40 + 3                  # the driver's seeds pass 32 bits
    assert torch.equal(draw(big), draw(big))
    assert draw(big).dtype == torch.float64
    assert not torch.equal(draw(big), draw(big + 1))


def test_generator_and_reservoir_repeat_from_a_seed():
    ctx = common.Ctx(workload="w", cfg={}, traffic={}, seed=2**40 + 3,
                     device="cpu", problem=None)
    x1 = torch.randn(64, generator=common.generator(ctx, 1))
    x2 = torch.randn(64, generator=common.generator(ctx, 1))
    assert torch.equal(x1, x2)

    def sample(seed):
        r = common.Reservoir(3, seed)
        for i in range(1000):
            r.offer(i)
        return r.sample()

    assert sample(9) == sample(9) and sample(9)[-1] == 999
    assert sample(9) != sample(10)
