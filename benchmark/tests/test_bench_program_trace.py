"""``lib/program_trace.py`` on synthetic stamps and events: the fold of the
program's region stamps, the split of a profile's events into the device's
own activities and the host ranges of the harness and of the program, and
the idle gaps named by the innermost range open."""

import types

import pytest
import torch

from benchmark.lib.program_trace import ProgramTrace, fold, readings, \
    split_events


def _stamps(*items):
    """``(name, 'enter' | 'exit', ns)`` from ``(name, kind, us)``."""
    return [(n, k, int(us * 1000)) for n, k, us in items]


def test_fold_nests_repeats_and_skips_the_unmatched():
    stamps = _stamps(
        ('train.adam', 'exit', 0),              # an exit with no enter
        ('train.critic', 'enter', 10),
        ('train.adam', 'enter', 12), ('train.adam', 'exit', 15),
        ('train.adam', 'enter', 20),
        ('train.adam', 'enter', 21), ('train.adam', 'exit', 22),  # nested
        ('train.adam', 'exit', 26),
        ('train.critic', 'exit', 30),
        ('serve.plan', 'enter', 40))            # never closed
    out = fold(stamps)
    assert set(out) == {'train.critic', 'train.adam'}
    assert out['train.critic'] == (pytest.approx(20e-6), 1)
    assert out['train.adam'] == (pytest.approx(9e-6), 2)


def _event(name, start_us, end_us, device, annotation=False):
    return types.SimpleNamespace(
        name=name, is_user_annotation=annotation,
        device_type=(torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU),
        time_range=types.SimpleNamespace(start=start_us, end=end_us))


def test_split_drops_mirrored_ranges_and_keeps_both_kinds_of_host_range():
    events = [_event('kernel', 0, 10, True),
              _event('exposure.fused.run', 0, 50, True),   # mirrored
              _event('bench.dispatch', 0, 60, True),       # mirrored
              _event('annotated', 5, 6, True, annotation=True),
              _event('bench.dispatch', 0, 60, False),
              _event('exposure.fused.run', 1, 50, False),
              _event('aten::copy_', 2, 3, False)]
    device, host = split_events(events)
    assert device == [('kernel', 0.0, 10e-6)]
    assert [h[0] for h in host] == ['bench.dispatch', 'exposure.fused.run']


def test_idle_gaps_name_the_innermost_range_and_readings_fold():
    device = [('k1', 0.0, 1.0), ('k2', 2.0, 3.0), ('k3', 5.0, 6.0)]
    host = [('bench.dispatch', 0.5, 6.0),
            ('exposure.fused.run', 0.6, 5.5),
            ('exposure.fused.table', 0.9, 1.5),
            ('bench.wait', 3.0, 4.0)]
    t = ProgramTrace(device, host, units=2)
    gaps = dict((round(s, 6), n) for n, s in t.breakdown()['idle_gaps'])
    assert gaps == {1.0: 'exposure.fused.table', 2.0: 'wait'}
    assert t.host_at(7.0) == 'other'
    assert t.host_seconds('fused.run') == pytest.approx(4.9)
    stamps = _stamps(('train.critic', 'enter', 0), ('train.critic', 'exit',
                                                     3000))
    assert readings(stamps, t) == {
        'train.critic_region_ms': pytest.approx(1.5),
        'train.dispatch_host_ms': pytest.approx(2450.0)}
