"""Configs as a table of knobs.

The JAX package's configs are Python modules that import ``exposure_tpu``
(and with it ``jax``) to name their filter classes, so the port cannot
load them.  It keeps its own table: one row for each of the 15 modules of
``configs/``, each derived from its parent as the module is (``example``
-> ``synthetic`` -> ``synthetic_explore`` -> ``synthetic_inject*``, ...),
with every knob of the JAX config and its three data providers, with the
JAX arguments.  ``example`` and ``sintel`` read the FiveK files relative to
the working directory, as the JAX configs do.  The knobs that the JAX
``agent_step`` reads with ``cfg.get`` and a default (``replay_inject_*``,
``entropy_respike*``) are in the table with those defaults, and so are the
ones the JAX trainer reads so (``critic_burst``, ``warmup_giters``,
``checkpoint_interval``, ``seed``).  The learning-rate schedules
``lr_g``/``lr_c`` are callables of the iteration.  Filters are named by the
JAX class ``__name__``; ``ops.filters.build_filters`` maps each name to
its port.  ``iters_per_dispatch`` and ``dispatch_pipeline_depth`` size the
trainer's fused dispatches and the deferral of its bookkeeping
(``core/trainer.py``): 100 and 2 in ``example`` and the configs derived
from it, 1 and 0 in ``test``.  ``tests/test_torch_serving.py`` holds every
row equal to ``exposure_tpu.utils.load_config(name)`` in both directions.
"""

from exposure_tpu_torch.utils.dict_util import Dict

_BANK = ('ExposureFilter', 'GammaFilter', 'ImprovedWhiteBalanceFilter',
         'SaturationPlusFilter', 'ToneFilter', 'ContrastFilter',
         'WNBFilter', 'ColorFilter')


def _example():
    cfg = Dict(
        # filter bank
        filters=_BANK,
        curve_steps=8,
        gamma_range=3,
        exposure_range=3.5,
        wb_range=1.1,
        color_curve_range=(0.90, 1.10),
        lab_curve_range=(0.90, 1.10),
        tone_curve_range=(0.5, 2),
        masking=False,
        minimum_strength=0.3,
        maximum_sharpness=1,
        clamp=False,
        # action selection, trajectory and penalties
        exploration=0.05,
        img_include_states=True,
        test_steps=5,
        exploration_penalty=0.05,
        filter_usage_penalty=1.0,
        early_stop_penalty=1.0,
        # off-policy replay injection and the entropy re-spike (training
        # knobs of agent_step; off unless a config sets them)
        replay_inject_prob=0.0,
        replay_inject_until=1.0,
        replay_inject_mode='uniform',
        entropy_respike=0.0,
        entropy_respike_center=0.5,
        entropy_respike_width=0.15,
        # networks
        source_img_size=64,
        base_channels=32,
        dropout_keep_prob=0.5,
        share_feed_dict=True,
        shared_feature_extractor=True,
        fc1_size=128,
        bnw=False,
        feature_extractor_dims=4096,
        real_img_channels=3,
        real_img_size=64,
        img_channels=3,
        # evaluation and the data providers
        supervised=False,
        batch_size=64,
        vis_step_test=False,
        # RL and the replay pool
        critic_logit_multiplier=0.05,
        discount_factor=1.0,
        use_TD=True,
        test_random_walk=False,
        replay_memory_size=128,
        maximum_trajectory_length=7,
        over_length_keep_prob=0.5,
        all_reward=1.0,
        # GAN
        use_penalty=True,
        gan='w',
        giters=1,
        citers=5,
        gradient_penalty_lambda=10,
        critic_initialization=10,
        clamp_critic=0.01,
        median_filter_size=101,
        z_type='uniform',
        z_dim_per_filter=16,
        # the schedule and the optimizers
        max_iter_step=20000,
        parameter_lr_mul=1,
        value_lr_mul=10,
        adam_beta1=0.5,
        adam_beta2=0.9,
        num_samples=64,
        summary_freq=100,
        # the trainer's cfg.get knobs, at the JAX trainer's defaults
        critic_burst=100,
        warmup_giters=100,
        checkpoint_interval=500,
        seed=0,
        # the trainer's dispatch: 100 plain iterations a fused chunk, its
        # bookkeeping two chunks behind
        iters_per_dispatch=100,
        dispatch_pipeline_depth=2,
        # observability
        vis_draw_critic_scores=True,
        realtime_vis=False,
        write_image_interval=400,
    )
    _filter_dims(cfg)
    cfg.lr_g = _decayed(cfg, 0.3)
    cfg.lr_c = _decayed(cfg, 1.0)
    return _fivek_inputs(cfg)


def _filter_dims(cfg):
    cfg.num_state_dim = 3 + len(cfg.filters)
    cfg.z_dim = 3 + len(cfg.filters) * cfg.z_dim_per_filter


def _fivek_inputs(cfg):
    """The FiveK RAW providers of ``configs/config_example.py``: the
    ``2k_train`` fold for training, ``u_test`` for testing, read from
    ``data/`` under the working directory."""
    from exposure_tpu_torch.data.fivek import FiveKDataProvider
    cfg.fake_data_provider = lambda: FiveKDataProvider(
        set_name='2k_train', raw=True, bnw=cfg.bnw, output_size=64,
        default_batch_size=cfg.batch_size, augmentation=0.3)
    cfg.fake_data_provider_test = lambda: FiveKDataProvider(
        set_name='u_test', raw=True, bnw=cfg.bnw, output_size=64,
        default_batch_size=cfg.batch_size, augmentation=0.0)
    cfg.real_data_provider = lambda: _artist(cfg)
    return cfg


def _artist(cfg):
    from exposure_tpu_torch.data.artist import ArtistDataProvider
    return ArtistDataProvider(
        set_name='2k_target', name='FiveK_C', bnw=cfg.bnw, output_size=64,
        default_batch_size=cfg.batch_size, augmentation=1.0)


def _decayed(cfg, mul, base_lr=5e-5, decay=0.1, segments=3):
    """``configs/config_example.py``'s learning-rate schedule: ``mul *
    base_lr`` decayed tenfold over each third of ``cfg.max_iter_step``,
    read when called (as there, a later change of ``max_iter_step`` moves
    the schedule)."""
    def schedule(t):
        return mul * base_lr * decay ** (1.0 * t * segments /
                                         cfg.max_iter_step)
    return schedule


def _synthetic_providers(cfg, n_train, n_test, texture=0.0, spread=0.0):
    """The three procedural providers of a config: un-retouched inputs for
    training and for testing, and the retouched targets (``spread`` widens
    the targets only, as ``configs/config_synthetic_wide.py`` does)."""
    from exposure_tpu_torch.data.synthetic import SyntheticDataProvider
    cfg.fake_data_provider = lambda: SyntheticDataProvider(
        n=n_train, size=80, style='raw', seed=0, texture=texture,
        output_size=64, augmentation=0.3,
        default_batch_size=cfg.batch_size)
    cfg.fake_data_provider_test = lambda: SyntheticDataProvider(
        n=n_test, size=80, style='raw', seed=1, texture=texture,
        output_size=64, augmentation=0.0,
        default_batch_size=cfg.batch_size)
    cfg.real_data_provider = lambda: SyntheticDataProvider(
        n=n_train, size=64, style='retouched', seed=2, texture=texture,
        spread=spread, output_size=64, augmentation=1.0,
        default_batch_size=cfg.batch_size)
    return cfg


def _paired_providers(cfg, n_train, n_test):
    """Supervised mode's providers: paired (input, ground truth) crops for
    training and testing; the targets only feed the visualization."""
    from exposure_tpu_torch.data.synthetic import (
        PairedSyntheticDataProvider,
        SyntheticDataProvider,
    )
    cfg.fake_data_provider = lambda: PairedSyntheticDataProvider(
        n=n_train, size=80, seed=0, output_size=64, augmentation=0.3,
        default_batch_size=cfg.batch_size)
    cfg.fake_data_provider_test = lambda: PairedSyntheticDataProvider(
        n=n_test, size=80, seed=1, output_size=64, augmentation=0.0,
        default_batch_size=cfg.batch_size)
    cfg.real_data_provider = lambda: SyntheticDataProvider(
        n=n_train, size=64, style='retouched', seed=2,
        output_size=64, augmentation=1.0,
        default_batch_size=cfg.batch_size)
    return cfg


def _test():
    cfg = _example()
    cfg.update(
        base_channels=16,
        feature_extractor_dims=1024,
        fc1_size=32,
        batch_size=16,
        replay_memory_size=32,
        num_samples=16,
        max_iter_step=20,
        critic_initialization=1,
        citers=2,
        critic_burst=4,
        summary_freq=5,
        write_image_interval=0,
        warmup_giters=6,
        checkpoint_interval=2,
        iters_per_dispatch=1,
        dispatch_pipeline_depth=0)
    return _synthetic_providers(cfg, n_train=64, n_test=32)


def _synthetic():
    return _synthetic_providers(_example(), n_train=2048, n_test=256)


def _synthetic_explore():
    cfg = _synthetic()
    cfg.exploration_penalty = 0.2
    return cfg


def _masked():
    cfg = _synthetic()
    cfg.masking = True
    cfg.filters = tuple(cfg.filters) + ('VignetFilter', 'LevelFilter')
    _filter_dims(cfg)
    return cfg


def _synthetic_tex():
    return _synthetic_providers(_synthetic(), n_train=2048, n_test=256,
                                texture=1.0)


def _synthetic_tex_explore():
    cfg = _synthetic_tex()
    cfg.exploration_penalty = 0.2
    return cfg


def _synthetic_wide():
    return _synthetic_providers(_synthetic(), n_train=2048, n_test=256,
                                spread=1.0)


def _injecting(prob):
    """``synthetic_explore`` with replay-pool injection at ``prob`` until
    75% of training (``configs/config_synthetic_inject*.py``)."""
    def make():
        cfg = _synthetic_explore()
        cfg.replay_inject_prob = prob
        cfg.replay_inject_until = 0.75
        return cfg
    return make


def _synthetic_respike():
    cfg = _synthetic_explore()
    cfg.entropy_respike = 1.0
    cfg.entropy_respike_center = 0.5
    cfg.entropy_respike_width = 0.15
    return cfg


def _supervised():
    cfg = _example()
    cfg.update(supervised=True, critic_burst=0, max_iter_step=5000)
    return _paired_providers(cfg, n_train=2048, n_test=256)


def _supervised_test():
    cfg = _test()
    cfg.update(supervised=True, citers=2, critic_burst=0)
    return _paired_providers(cfg, n_train=64, n_test=32)


def _sintel():
    """``example`` with any folder of images as the targets."""
    from exposure_tpu_torch.data.folder import FolderDataProvider
    cfg = _example()
    cfg.real_data_provider = lambda: FolderDataProvider(
        folder='data/sintel/outputs', default_batch_size=cfg.batch_size)
    return cfg


# config_synthetic.py changes only the data (its dispatch knobs restate
# the example's), and config_synthetic_explore.py only exploration_penalty
CONFIGS = {
    'example': _example,
    'synthetic': _synthetic,
    'synthetic_explore': _synthetic_explore,
    'synthetic_inject': _injecting(0.1),
    'synthetic_inject15': _injecting(0.15),
    'synthetic_inject2': _injecting(0.2),
    'synthetic_respike': _synthetic_respike,
    'synthetic_tex': _synthetic_tex,
    'synthetic_tex_explore': _synthetic_tex_explore,
    'synthetic_wide': _synthetic_wide,
    'supervised': _supervised,
    'supervised_test': _supervised_test,
    'sintel': _sintel,
    'test': _test,
    'masked': _masked,
}


def load_config(config_name):
    """A fresh copy of the named config's knobs."""
    try:
        make = CONFIGS[config_name]
    except KeyError:
        raise KeyError('no config %r; known: %s'
                       % (config_name, sorted(CONFIGS))) from None
    cfg = make()
    cfg.name = config_name
    return cfg
