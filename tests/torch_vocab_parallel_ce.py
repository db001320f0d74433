"""A rank function for the tests of the vocab-parallel cross-entropy
(``repro_torch.train.train_step.cross_entropy`` with a split vocab): run it
on every rank of a ``repro_torch.launch.mesh.spawn_ranks`` group."""
import torch


def placed_cross_entropy(rank, logits, labels, mask,
                         z_loss_coef: float = 1e-4) -> dict:
    """One rank of the vocab-parallel cross-entropy over all the launched
    ranks as one 'model' group: ``logits`` (rows, S, V), ``labels`` (rows,
    S) and ``mask`` (numpy, whole on every rank), of which the rank takes
    its contiguous V/tp columns. Returns the CE, the z-loss, the gradient
    of their sum with respect to the rank's columns (numpy) and the
    collectives sent."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import tensor_parallel
    from repro_torch.launch.roofline import record_collectives
    from repro_torch.train.train_step import cross_entropy

    dev = rank.device
    mesh = init_device_mesh(dev.type, (1, dist.get_world_size()),
                            mesh_dim_names=("data", "model"))
    tp = tensor_parallel(mesh)
    n = logits.shape[-1] // tp.size
    mine = torch.as_tensor(logits[..., tp.rank * n:(tp.rank + 1) * n],
                           device=dev).requires_grad_(True)
    with record_collectives() as coll:
        ce, zl = cross_entropy(
            mine, torch.as_tensor(labels, device=dev, dtype=torch.int64),
            torch.as_tensor(mask, device=dev, dtype=torch.float32),
            z_loss_coef, vocab=tp)
        grad, = torch.autograd.grad(ce + zl, mine)
    return {"ce": float(ce.detach()), "z_loss": float(zl.detach()),
            "grad": grad.cpu().numpy(), "collectives": coll}
