"""Multi-device and multi-process rendering and training (twin of
`raytracing_tpu.parallel`).

  shard       — `DeviceMesh`, `make_device_mesh`, `render_sharded`,
                `make_train_step`: the ray batch sharded over the devices
                of one process, the scene replicated
  distributed — `initialize` (a `torch.distributed` process group),
                `global_ray_mesh`, `render_distributed`,
                `save_local_shards`, `assemble_shards`: the frame split
                over processes, each writing its own shards
  dryrun      — `entry`, `dryrun_multichip`: one sharded train step on a
                small scene
"""
