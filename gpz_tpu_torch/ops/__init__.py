from gpz_tpu_torch.ops.vc_phi import vc_lnphi_complete, vc_lnphi_plain

__all__ = ["vc_lnphi_complete", "vc_lnphi_plain"]
