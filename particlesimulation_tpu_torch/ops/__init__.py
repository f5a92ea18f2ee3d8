"""Tile and particle operations of the fast engine (torch, plus CUDA kernels
under ``ops.cuda``)."""
