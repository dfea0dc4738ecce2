"""`python -m f_lite_tpu_torch.train`: the port's trainer."""

from f_lite_tpu_torch.train.trainer import main

if __name__ == "__main__":
    main()
