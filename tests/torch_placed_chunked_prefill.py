"""A rank function for the tests of a placed prefill at ``cache_index >
0`` (a prompt prefilled in two chunks): run it on every rank of a
``repro_torch.launch.mesh.spawn_ranks`` group."""
import torch


def placed_chunked_prefill(rank, cfg, mesh_shape: tuple, tokens,
                           split: int, cache_len: int) -> dict:
    """One rank: the model of ``cfg`` placed on (data, model)
    ``mesh_shape`` as ``sharding.placed_serve`` places it prefills the
    rank's rows of ``tokens[:, :split]`` (numpy (B, S)) into a fresh cache
    of ``cache_len`` slots, then ``tokens[:, split:]`` at ``cache_index``
    ``split``, whose queries attend the cache (an attention whose slot
    group has more than one rank merges the ranks' blocks). Returns each
    chunk's last logits of the whole batch (numpy, f32) and the collectives
    the second chunk sent."""
    from repro_torch.distributed.sharding import (_placed_model, axis_size,
                                                  coordinate, gather_batch,
                                                  local_batch)
    from repro_torch.launch.roofline import record_collectives
    from repro_torch.models import init_cache

    mesh, model, _ = _placed_model(rank, cfg, mesh_shape)
    prompt = local_batch(mesh, {"tokens": tokens})["tokens"].to(rank.device)
    cache = init_cache(cfg, prompt.shape[0], cache_len, rank.device,
                       tp=axis_size(mesh, "model"),
                       rank=coordinate(mesh)["model"])
    with torch.inference_mode():
        first, _ = model({"tokens": prompt[:, :split]}, cache, 0,
                         last_only=True)
        with record_collectives() as coll:
            second, _ = model({"tokens": prompt[:, split:]}, cache, split,
                              last_only=True)
        out = [gather_batch(mesh, x[:, -1], len(tokens)).float().cpu()
               .numpy() for x in (first, second)]
    return {"first": out[0], "second": out[1], "collectives": coll}
