"""Host-side native code of the port: the ray-parity voxelizer
(``geometry.cpp``), built with ``g++`` at first use and called by ctypes."""
