from physdock_tpu_torch.data.constants import periodic_table, restypes  # noqa: F401
