"""The multi-device layer: ``torch.distributed`` meshes and the sharded
encode (the port of ``jpeg_tpu.parallel``)."""
