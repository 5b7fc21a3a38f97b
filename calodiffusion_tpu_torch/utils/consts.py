"""Normalization-constant registry for the supported datasets.

A copy of ``calodiffusion_tpu/utils/consts.py``: the port imports nothing of the
JAX package.

These are *measured physics constants* of the public CaloChallenge / CMS HGCal
datasets (means/stds of logit- and log-transformed voxel energies, layer-energy
statistics, quantile-transform paths).  They must match the reference registry
exactly for preprocessing compatibility (reference: calodiffusion/utils/consts.py,
`dataset_params` keyed by dataset_num {0,1,2,3,10,11,100,101,111,120,121}).

Keys
----
0/1:      CaloChallenge dataset 1 pions / photons (GLaM-converted regular grid)
10/11:    same, original (irregular, flat) shape
2/3:      CaloChallenge datasets 2 / 3
100/101:  CMS HGCal (william v1 / v2)
111:      HGCal, embedding applied during preprocessing ("pre-embed")
120/121:  HGCal central production pions / photons, pre-embed
"""

dataset_params = {
    # CaloChallenge dataset 1, pions
    0: {
        "logit_mean": -12.4783,
        "logit_std": 2.21267,
        "logit_min": -13.81551,
        "logit_max": 0.9448,
        "log_mean": 0.0,
        "log_std": 1.0,
        "log_min": 0.0,
        "log_max": 2.0,
        "totalE_mean": 0.0,
        "totalE_std": 1.0,
        "layers_mean": 0.0,
        "layers_std": 1.0,
        "layerN_logit_mean": 0.0,
        "layerN_logit_std": 1.0,
        "qt": "qts/dset1_pions_quantile_transform.gz",
    },
    # CaloChallenge dataset 1, photons
    1: {
        "logit_mean": -12.1444,
        "logit_std": 2.45056,
        "logit_min": -13.81551,
        "logit_max": -1.6615,
        "log_mean": 0.0,
        "log_std": 1.0,
        "log_min": 0.0,
        "log_max": 2.0,
        "totalE_mean": 0.0,
        "totalE_std": 1.0,
        "layers_mean": 0.0,
        "layers_std": 1.0,
        "layerN_logit_mean": 0.0,
        "layerN_logit_std": 1.0,
        "qt": "qts/dset1_photons_quantile_transform.gz",
    },
    # CaloChallenge dataset 2
    2: {
        "logit_mean": -12.8564,
        "logit_std": 1.9123,
        "logit_min": -13.8155,
        "logit_max": 0.1153,
        "log_mean": -17.5451,
        "log_std": 4.4086,
        "log_min": -20.0,
        "log_max": -0.6372,
        "totalE_mean": 0.3926,
        "totalE_std": 0.05546,
        "layers_mean": -6.35551,
        "layers_std": 3.90699,
        "layerN_logit_mean": -9.2022,
        "layerN_logit_std": 5.69892,
        "qt": "qts/dset2_quantile_transform.gz",
    },
    # CaloChallenge dataset 3
    3: {
        "logit_mean": -13.4753,
        "logit_std": 1.1070,
        "logit_min": -13.81551,
        "logit_max": 0.2909,
        "log_mean": -1.1245,
        "log_std": 3.3451,
        "log_min": -18.6905,
        "log_max": 0.0,
        "totalE_mean": 0.0,
        "totalE_std": 1.0,
        "layers_mean": 0.0,
        "layers_std": 1.0,
        "qt": "qts/dset3_quantile_transform.gz",
    },
    # dataset 1 pions, original (flat irregular) shape
    10: {
        "logit_mean": -11.7610,
        "logit_std": 2.84317,
        "logit_min": -13.81551,
        "logit_max": 0.2554,
        "log_mean": 0.0,
        "log_std": 1.0,
        "log_min": 0.0,
        "log_max": 2.0,
        "totalE_mean": 0.2359,
        "totalE_std": 0.08255,
        "layers_mean": -4.9742,
        "layers_std": 4.89629,
        "layerN_logit_mean": -8.1456,
        "layerN_logit_std": 5.43684,
        "qt": None,
    },
    # dataset 1 photons, original (flat irregular) shape
    11: {
        "logit_mean": -9.9807,
        "logit_std": 3.14168,
        "logit_min": -13.81551,
        "logit_max": 0.2554,
        "log_mean": 0.0,
        "log_std": 1.0,
        "log_min": 0.0,
        "log_max": 2.0,
        "totalE_mean": 0.3123,
        "totalE_std": 0.02872,
        "layers_mean": -4.9023,
        "layers_std": 5.17364,
        "layerN_logit_mean": -8.2197,
        "layerN_logit_std": 4.18973,
        "qt": None,
    },
    # HGCal william v1
    100: {
        "logit_mean": -13.7371,
        "logit_std": 0.68639,
        "logit_min": -13.81551,
        "logit_max": 0.2909,
        "totalE_mean": 0.0055,
        "totalE_std": 0.00018,
        "layers_mean": -4.4450,
        "layers_std": 2.37667,
    },
    # HGCal william v2
    101: {
        "logit_mean": -18.3170,
        "logit_std": 1.03153,
        "logit_min": -13.81551,
        "logit_max": 0.2909,
        "embed_mean": 0.0835,
        "embed_std": 3.1083,
        "totalE_mean": 0.5538,
        "totalE_std": 0.01767,
        "layers_mean": -4.5836,
        "layers_std": 2.98382,
    },
    # HGCal, embedding-first
    111: {
        "logit_mean": -17.3442,
        "logit_std": 3.26085,
        "logit_min": -13.81551,
        "logit_max": 0.2909,
        "embed_mean": 0.0,
        "embed_std": 1.0,
        "totalE_mean": 1.1076,
        "totalE_std": 0.03535,
        "layers_mean": -4.5836,
        "layers_std": 2.98382,
    },
    # HGCal pion central production, embedding-first
    120: {
        "logit_mean": -18.1561,
        "logit_std": 1.56255,
        "logit_min": -13.0,
        "logit_max": 13.0,
        "embed_mean": 0.0,
        "embed_std": 1.0,
        "totalE_mean": 0.5389,
        "totalE_std": 0.30325,
        "layers_mean": -6.7899,
        "layers_std": 5.64943,
    },
    # HGCal photon central production, embedding-first
    121: {
        "logit_mean": -17.8664,
        "logit_std": 2.34207,
        "logit_min": -13.0,
        "logit_max": 13.0,
        "embed_mean": 0.0,
        "embed_std": 1.0,
        "totalE_mean": 1.0270,
        "totalE_std": 0.09394,
        "layers_mean": -11.6495,
        "layers_std": 7.31088,
    },
}

# Fallback used when a dataset has no measured constants yet.
blank_params = {
    "logit_mean": 0.0,
    "logit_std": 1.0,
    "logit_min": -13.0,
    "logit_max": 13.0,
    "embed_mean": 0.0,
    "embed_std": 1.0,
    "totalE_mean": 0.0,
    "totalE_std": 1.0,
    "layers_mean": 0.0,
    "layers_std": 1.0,
}

# Radial bin centers (mm) used to build the constant R/Z conditioning images
# (reference: calodiffusion/utils/utils.py create_R_Z_image, r_bins tables).
R_BIN_EDGES = {
    # dataset 1 pions
    0: [0.0, 1.0, 4.0, 5.0, 7.0, 10.0, 15.0, 20.0, 30.0, 50.0, 80.0, 90.0,
        100.0, 130.0, 150.0, 160.0, 200.0, 250.0, 300.0, 350.0, 400.0, 600.0,
        1000.0, 2000.0],
    # dataset 1 photons
    1: [0.0, 2.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 15.0, 20.0, 25.0, 30.0,
        40.0, 50.0, 60.0, 70.0, 80.0, 90.0, 100.0, 120.0, 130.0, 150.0, 160.0,
        200.0, 250.0, 300.0, 350.0, 400.0, 600.0, 1000.0, 2000.0],
    # dataset 2
    2: [0.0, 4.65, 9.3, 13.95, 18.6, 23.25, 27.9, 32.55, 37.2, 41.85],
    # dataset 3
    3: [0.0, 2.325, 4.65, 6.975, 9.3, 11.625, 13.95, 16.275, 18.6, 20.925,
        23.25, 25.575, 27.9, 30.225, 32.55, 34.875, 37.2, 39.525, 41.85],
}
