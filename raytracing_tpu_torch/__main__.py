"""`python -m raytracing_tpu_torch render|animate|bench|fit` (`app.main`).
Importing this module runs nothing."""

from raytracing_tpu_torch.app import main

if __name__ == "__main__":
    main()
