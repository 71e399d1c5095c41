"""Model families of the port (DLRM so far) on torch tensors."""
