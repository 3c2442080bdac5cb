from tnc_tpu_torch.io.hdf5 import load_data, load_tensor, store_data  # noqa: F401
