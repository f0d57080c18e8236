"""Host-side geometry of the port. So far only the KITTI text/scan loaders
(``kitti``) that online loop closing reads its poses, calibration and
covariances with."""
