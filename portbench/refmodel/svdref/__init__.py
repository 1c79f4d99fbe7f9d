"""The benchmark's frozen copy of the plain Stable Video Diffusion
reference (``tests/reference/svd_reference.py`` when the cell
``svd_img2vid.video14_576x1024`` was added): float32 PyTorch written from
the published sgm modules, importing nothing outside ``portbench/``."""
