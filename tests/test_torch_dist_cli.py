"""The data-parallel layer's refusals and one-process behaviour, without
processes (the CLIs over two ranks: tests/test_torch_dist_trainer.py):
`--data_axis` or `--model_axis` without a world of its size is refused, and
a spatial layout the model's maps cannot take is refused naming its
constraint; the encoder's and the
discriminator's batch norms take the global batch's statistics over a
simulated second rank; without a process group every function of
deepsee_torch.parallel is the one-process identity."""

import dataclasses

import pytest
import torch

from deepsee_torch.config import MeshConfig, tiny_test_experiment
from deepsee_torch.models import layers
from deepsee_torch.models.layers import TorchBatchNorm
from deepsee_torch.parallel import distributed
from deepsee_torch.system import SRSystem
from deepsee_torch.train import __main__ as cli
from deepsee_torch.train.loop import check_data_parallel


def test_data_axis_needs_a_world_of_its_size(monkeypatch):
    monkeypatch.setattr(cli, "get_preset", lambda name: tiny_test_experiment())
    for flags, ranks in ((["--data_axis", "2"], 2), (["--data_axis", "2", "--dcn_axis", "2"], 4)):
        with pytest.raises(ValueError, match=f"= {ranks} data-parallel ranks, but the world "
                                             "has 1 process"):
            cli.main(flags + ["--synthetic", "--device", "cpu", "--max_steps", "1"])
    # the Trainer holds the layout it is given to the same rule
    check_data_parallel(tiny_test_experiment(), 1)
    for mesh, world in ((MeshConfig(data_axis=2), 1), (MeshConfig(), 2),
                        (MeshConfig(data_axis=-1, dcn_axis=-2), 2)):
        with pytest.raises(ValueError, match="data-parallel ranks, but the world has"):
            check_data_parallel(tiny_test_experiment().replace(mesh=mesh), world)


def test_model_axis_needs_a_world_of_its_size(monkeypatch):
    monkeypatch.setattr(cli, "get_preset", lambda name: tiny_test_experiment())
    with pytest.raises(ValueError, match="x model_axis 2 = 2 ranks, but the world has 1 process"):
        cli.main(["--model_axis", "2", "--synthetic", "--device", "cpu", "--max_steps", "1"])
    with pytest.raises(ValueError, match="x model_axis 2 = 4 ranks, but the world has 2"):
        check_data_parallel(tiny_test_experiment().replace(
            mesh=MeshConfig(data_axis=2, model_axis=2)), 2)


@pytest.mark.parametrize("flags,slice_name", [
    (["--partition", "spatial", "--model_axis", "3"], "model_axis 3 does not divide start_size")])
def test_layouts_of_later_slices_are_refused(capsys, flags, slice_name):
    """A spatial layout whose stripes the preset's maps cannot take is
    refused at parse time, naming the constraint."""
    with pytest.raises(SystemExit):
        cli.parse_args(flags + ["--synthetic"])
    assert slice_name in capsys.readouterr().err


@pytest.mark.parametrize("field,norm", [("norm_e", "spectralsync_batch"),
                                        ("norm_d", "spectralbatch"), ("norm_e", "batch")])
def test_encoder_and_discriminator_batch_norms_take_the_global_batch(monkeypatch, field, norm):
    """A train-mode batch norm of the encoder or discriminator over two
    ranks whose rows are alike, the second rank simulated in the collective
    (its partials row a copy of this rank's, its gradient sums equal to
    this rank's): the output, the running statistics and the gradient of
    this rank's rows are one process's on the global batch (both ranks'
    rows), whose loss is the sum of both ranks' losses.  The cross-rank
    run itself is in test_torch_dist_norms.py."""
    exp = tiny_test_experiment()
    exp = exp.replace(model=dataclasses.replace(exp.model, **{field: norm}))
    net = getattr(SRSystem(exp, device="cpu"), "encoder" if field == "norm_e" else
                  "discriminator")
    bns = [m for m in net.modules() if isinstance(m, TorchBatchNorm)]
    assert bns, f"{field}={norm!r} builds no batch norm"
    gen = torch.Generator().manual_seed(0)
    c = bns[0].running_mean.numel()
    x = (torch.randn(2, c, 4, 4, generator=gen) * 2 + 1).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(2, c, 4, 4, generator=gen)
    with torch.no_grad():
        bns[0].weight.normal_(0, 0.3, generator=gen)
        bns[0].bias.normal_(0, 0.3, generator=gen)
    stats = (bns[0].running_mean.clone(), bns[0].running_var.clone())

    one_x = torch.cat([x, x]).requires_grad_(True)
    one_out = bns[0].train()(one_x)
    (one_out * torch.cat([w, w])).sum().backward()
    one_stats = (bns[0].running_mean.clone(), bns[0].running_var.clone())

    def all_reduce(t, *a, **k):
        if t.dim() == 3:   # the forward's [world, 3, C] partials
            t[1] = t[0]
        else:              # the backward's gradient sums
            t.mul_(2)

    with torch.no_grad():
        bns[0].running_mean.copy_(stats[0])
        bns[0].running_var.copy_(stats[1])
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(layers.dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(layers.dist, "get_rank", lambda *a: 0)
    monkeypatch.setattr(layers.dist, "all_reduce", all_reduce)
    x = x.clone().requires_grad_(True)
    out = bns[0](x)
    (out * w).sum().backward()
    torch.testing.assert_close(out, one_out[:2], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(x.grad, one_x.grad[:2], rtol=1e-5, atol=1e-6)
    for got, want in zip((bns[0].running_mean, bns[0].running_var), one_stats):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mesh,slice_name", [
    (MeshConfig(partition="spatial", model_axis=3), "model_axis 3 does not divide start_size")])
def test_trainer_refuses_the_layouts_of_later_slices(mesh, slice_name):
    """A spatial layout that does not stripe the model's maps evenly is
    refused, naming the constraint."""
    with pytest.raises(ValueError, match=slice_name):
        check_data_parallel(tiny_test_experiment().replace(mesh=mesh), 1)


def test_one_process_is_the_identity():
    assert (distributed.world_size(), distributed.rank()) == (1, 0)
    assert distributed.is_main_process()
    assert distributed.per_rank_batch(6) == 6
    draws = []
    out = distributed.rank_rows(lambda s: draws.append(s) or torch.zeros(s), (3, 2))
    assert draws == [(3, 2)] and out.shape == (3, 2)
    rows = {"a": torch.arange(6.0).reshape(3, 2)}
    assert torch.equal(distributed.gather_rows(rows, 2, 4)["a"], rows["a"][:2])
    grads = [torch.nn.Parameter(torch.ones(2))]
    grads[0].grad = torch.full((2,), 3.0)
    distributed.all_reduce_grads(grads)
    assert torch.equal(grads[0].grad, torch.full((2,), 3.0))
    logs = {"x": torch.tensor(1.5)}
    assert distributed.all_reduce_mean(logs) is logs


def test_per_rank_batch_needs_a_divisible_global_batch(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    assert distributed.per_rank_batch(6) == 2
    with pytest.raises(ValueError, match="not divisible by 3 processes"):
        distributed.per_rank_batch(4)


def test_rank_rows_keeps_this_ranks_rows_of_the_global_draw(monkeypatch):
    monkeypatch.setattr(distributed, "world_size", lambda: 2)
    monkeypatch.setattr(distributed, "rank", lambda: 1)
    full = torch.arange(24.0).reshape(4, 3, 2)
    got = distributed.rank_rows(lambda s: full[:s[0]], (2, 3, 2))
    assert torch.equal(got, full[2:4])


def test_init_needs_torchrun_and_a_card(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        distributed.init_distributed()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0"):
        distributed.local_device()
