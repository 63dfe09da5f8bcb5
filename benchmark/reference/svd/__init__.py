"""The plain reference of Stable Video Diffusion XT: a frozen copy of
plain_reference/svd_xt.py (torch and numpy only)."""
