from gpz_tpu_torch.data.photoz import load_sdss_csv, synthetic_sdss

__all__ = ["load_sdss_csv", "synthetic_sdss"]
