from gpz_tpu_torch.ops.vc_phi import (
    VcLnPhi, vc_lnphi_bwd, vc_lnphi_bwd_plain, vc_lnphi_complete,
    vc_lnphi_plain,
)

__all__ = ["VcLnPhi", "vc_lnphi_bwd", "vc_lnphi_bwd_plain",
           "vc_lnphi_complete", "vc_lnphi_plain"]
