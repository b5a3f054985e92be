"""The NGLOD app of the port."""
