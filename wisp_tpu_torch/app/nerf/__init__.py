"""The NeRF app of the port."""
