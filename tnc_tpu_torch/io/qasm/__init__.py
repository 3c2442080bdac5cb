from tnc_tpu_torch.io.qasm.importer import import_qasm  # noqa: F401
