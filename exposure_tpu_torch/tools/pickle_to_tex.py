"""Export an evaluation debug pickle as a standalone LaTeX/TikZ figure: a
copy of ``exposure_tpu/tools/pickle_to_tex.py`` (which imports nothing of
JAX), so that the tool runs where only the port is installed.

One figure per applied step: the action distribution, the chosen operation
and its parameters.  The debug pickle is the per-step dict list written by
``Evaluator.eval`` (``<fn>_debug.pkl``), of either package.

Usage: python -m exposure_tpu_torch.tools.pickle_to_tex outputs/<fn>_debug.pkl
"""

import argparse
import os
import pickle


def _pdf_bars(pdf, names, selected):
    lines = []
    width = 0.9 / max(len(pdf), 1)
    for i, p in enumerate(pdf):
        x = i * width
        color = 'red!70' if i == selected else 'blue!40'
        lines.append(
            r'\fill[%s] (%.3f, 0) rectangle (%.3f, %.3f);' %
            (color, x, x + width * 0.8, float(p) * 2.0))
        lines.append(
            r'\node[font=\tiny, anchor=north] at (%.3f, -0.02) {%s};' %
            (x + width * 0.4, names[i]))
    return lines


def _curve_plot(params, color='black'):
    # cumulative piecewise-linear curve (tone / color filters)
    vals = [0.0]
    total = sum(params) + 1e-30
    for p in params:
        vals.append(vals[-1] + float(p) / total)
    pts = ' -- '.join('(%.3f, %.3f)' % (i / (len(vals) - 1), v)
                      for i, v in enumerate(vals))
    return [r'\draw[%s, thick] %s;' % (color, pts)]


def step_to_tikz(step):
    names = step.get('all_short_names') or []
    pdf = step['pdf']
    if not names:
        names = [str(i) for i in range(len(pdf))]
    lines = [r'\begin{tikzpicture}[scale=2.2]']
    lines += _pdf_bars(pdf, names, step['filter_id'])
    name = step['short_name']
    params = [float(x) for x in step['filter_parameters'].reshape(-1)]
    lines.append(
        r'\node[font=\small, anchor=south west] at (0, 1.05) '
        r'{Step %d: \textbf{%s}};' % (step['step'] + 1, name))
    if name == 'T':
        lines += _curve_plot(params)
    elif name == 'C':
        k = len(params) // 3
        for c, color in enumerate(['red', 'green!60!black', 'blue']):
            lines += _curve_plot(params[c * k:(c + 1) * k], color)
    elif name == 'W':
        lines.append(
            r'\fill[rgb color={%.3f,%.3f,%.3f}] (0.3, 0.4) rectangle '
            r'(0.7, 0.6);' % tuple(min(max(p, 0.0), 1.0) for p in params))
    else:
        ptxt = ', '.join('%.2f' % p for p in params[:4])
        lines.append(
            r'\node[font=\tiny, anchor=south west] at (0, 0.9) {[%s]};'
            % ptxt)
    lines.append(r'\end{tikzpicture}')
    return '\n'.join(lines)


def convert(pkl_path, out_path=None):
    with open(pkl_path, 'rb') as f:
        debug = pickle.load(f)
    body = '\n\\quad\n'.join(step_to_tikz(s) for s in debug
                             if s.get('applied', True))
    doc = '\n'.join([
        r'\documentclass[border=5pt]{standalone}',
        r'\usepackage{tikz}',
        r'\begin{document}',
        body,
        r'\end{document}',
    ])
    if out_path is None:
        out_path = os.path.splitext(pkl_path)[0] + '.tex'
    with open(out_path, 'w') as f:
        f.write(doc)
    return out_path


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('pickles', nargs='+')
    args = parser.parse_args()
    for p in args.pickles:
        out = convert(p)
        print('wrote', out)


if __name__ == '__main__':
    main()
