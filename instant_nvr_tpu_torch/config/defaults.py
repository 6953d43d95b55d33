"""Default configuration tree.

Mirrors the reference defaults that matter for the inb (instant-nvr) pipeline
(reference ``lib/config/config.py:10-300``), dropping dead keys (Coco*,
sdf/forward-rendering variants that have no living code path) and adding the
TPU-specific knobs introduced by this rebuild (static budgets, precision,
mesh shape).  Key names are kept identical so ``configs/inb/*.yaml`` port 1:1.
"""
from .config import Config

_DEFAULTS = dict(
    # -- identity ---------------------------------------------------------
    task="inb",
    exp_name="default",
    silent=False,
    debug=False,
    # -- hash-grid primes (reference lib/config/config.py:17) -------------
    ps=[1, 19349663, 83492791],
    # -- model dims -------------------------------------------------------
    latent_code_dim=8,
    geo_feature_dim=16,
    num_latent_code=-1,
    aggr="",                       # '' = max-occupancy argmax; 'mean' | 'dist'
    part_deform=False,
    tpose_viewdir=True,
    tpose_geometry=True,
    bigpose=True,
    use_knn=True,
    knn_k=4,
    knn_radius=0.075,              # gaussian aggregation radius (blend_utils.py:741)
    smpl_thresh=0.1,
    bbox_overlap=0.2,
    use_batch_bounds=True,
    network=dict(
        occ=dict(d_hidden=64, n_layers=1),
        color=dict(d_hidden=64, n_layers=2),
    ),
    viewdir_embedder=dict(kwargs=dict(res=4, input_dims=3)),
    # -- rendering --------------------------------------------------------
    N_samples=64,
    N_importance=0,                # hierarchical sampling (off in reference inb path)
    N_rand=1024,
    perturb=1,
    raw_noise_std=0.0,
    white_bkgd=False,
    random_bg=False,
    chunk=4096,
    render_chunk=4096,
    # eval-only chunk override (-1 = use render_chunk).  Fatter eval chunks
    # amortize the per-lax.map-iteration fixed costs (KNN, sorts, selection)
    # over more rays; budgets are per-chunk fractions so HBM intermediates
    # scale with this knob — raise it only as far as the device allows.
    eval_render_chunk=-1,
    # -- TPU static-shape budgets (new in this rebuild) -------------------
    # fraction of ray-samples kept by the fixed-budget SMPL-distance cull
    # (replaces the reference's data-dependent nonzero gather,
    #  inb_part_network_multiassign.py:137)
    cull_budget=0.25,
    # per-part point budgets as fractions of the culled set; '' = dense vmap
    part_mode="budget",            # 'dense' | 'budget'
    part_budget=0.5,
    # measure cull/part budgets from probe dataset items at startup
    # (models/budget.py) instead of the human-tuned fractions above
    auto_budget=False,
    budget_headroom=1.25,
    knn_chunk=2048,                # query chunk for the brute-force KNN
    # -- precision --------------------------------------------------------
    mlp_dtype="bfloat16",          # matmul dtype for the tiny MLPs
    grid_dtype="float32",          # hash-table parameter dtype
    # -- data -------------------------------------------------------------
    ratio=0.5,
    eval_ratio=-1.0,
    mask_bkgd=True,
    erode_edge=True,
    body_sample_ratio=0.5,
    face_sample_ratio=0.0,
    box_padding=0.05,
    voxel_size=[0.005, 0.005, 0.005],
    training_view=[0],
    test_view=[],
    begin_ith_frame=0,
    num_train_frame=1,
    num_eval_frame=-1,
    frame_interval=1,
    smpl="smpl",
    lbs="smpl_lbs",
    params="smpl_params",
    vertices="smpl_vertices",
    smpl_meta="data/smpl-meta",
    test_on_training_view=False,
    test_novel_pose=False,
    sample_focus="",
    sample_using_mse=False,
    sample_mse_portion=0.8,
    train_with_coord=False,
    # -- losses -----------------------------------------------------------
    use_pair_reg=True,
    pair_loss_weight=1e-4,
    use_reg_distortion=False,
    reg_dist_weight=0.1,
    resd_loss_weight=0.1,
    rgb_resd_loss_coe=0.01,
    use_lpips=False,
    use_ssim=False,
    use_fourier=False,
    use_tv_image=False,
    patch_sampling=False,
    patch_size=64,
    use_freespace_loss=False,
    free_loss_weight=1e-4,
    use_occ_loss=False,
    occ_loss_weight=1e-4,
    mlp_weight_decay=1.0,
    # -- train loop -------------------------------------------------------
    train=dict(
        batch_size=1,
        lr=5e-4,
        eps=1e-15,
        weight_decay=0.0,
        epoch=6,
        optim="adam",
        scheduler=dict(type="exponential", gamma=0.1, decay_epochs=1000),
        num_workers=0,
        shuffle=True,
    ),
    test=dict(sampler="FrameSampler", batch_size=1, frame_sampler_interval=6, epoch=-1),
    val=dict(sampler="FrameSampler", batch_size=1, frame_sampler_interval=20, epoch=-1),
    ep_iter=500,
    save_ep=400,
    save_latest_ep=5,
    eval_ep=10,
    vis_ep=100,
    log_interval=100,
    record_interval=20,
    resume=True,
    fix_random=False,
    training_stages=[],
    # -- eval / output ----------------------------------------------------
    result_dir="exps",
    trained_model_dir="data/trained_model",
    record_dir="data/record",
    eval_part="",
    eval_whole_img=True,
    skip_eval=False,
    # lpips weights: optional path to a .npz of VGG conv weights; '' means
    # fixed-seed random features (documented deviation: no pretrained VGG
    # is shippable in this environment)
    lpips_weights="",
    # -- parallel (new) ---------------------------------------------------
    mesh_shape=[-1],               # [-1] = all local devices on one 'data' axis
    ray_axis="data",
    # -- profiling --------------------------------------------------------
    profiling=False,
    profiling_dir="data/record/profiling",
)


def default_config() -> Config:
    return Config(_DEFAULTS)
