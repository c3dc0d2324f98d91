"""Plotting helpers for HaMMLET output (bin/pyhammlet/plotting.py parity).

Matplotlib panel plots of data, posterior marginals, sampled state
sequences, block sizes, plus the quantile-band plot — mirroring the
reference's API surface (current-axes based, cmap/norm driven) in Python 3.
matplotlib is imported by the functions that draw, so that the rest of the
package runs where it is not installed.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib.pyplot on the Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt

#: the reference ships a 56-color palette (ColorBrewer Paired12 first);
#: this default is matplotlib's tab20 extended to stay deterministic
DEFAULT_PALETTE = [
    "#a6cee3", "#1f78b4", "#b2df8a", "#33a02c", "#fb9a99", "#e31a1c",
    "#fdbf6f", "#ff7f00", "#cab2d6", "#6a3d9a", "#ffff99", "#b15928",
    "#8dd3c7", "#bebada", "#fb8072", "#80b1d3", "#fdb462", "#b3de69",
    "#fccde5", "#d9d9d9", "#bc80bd", "#ccebc5", "#ffed6f", "#1b9e77",
]


def load_palette(path: str | None = None):
    """(cmap, norm) from a palette file with one #RRGGBB per line (the
    reference's -p option; bin/plotResults:226-236). Out-of-range states
    render black, like the reference's set_over/under/bad."""
    from matplotlib.colors import BoundaryNorm, ListedColormap

    if path is None:
        pal = list(DEFAULT_PALETTE)
    else:
        pal = [x.strip() for x in open(path) if x.strip()]
    norm = BoundaryNorm(range(len(pal) + 1), len(pal))
    cmap = ListedColormap(pal, name="HaMMLET")
    cmap.set_bad("k")
    cmap.set_over("k")
    cmap.set_under("k")
    return cmap, norm


def scaledImshow(matrix, cmap=None, norm=None, maxNrPixels=100_000_000,
                 **kwargs):
    """imshow with horizontal max-pooling once the pixel count exceeds
    maxNrPixels (the reference downsamples the same way so genome-scale
    panels stay drawable; plotting.py:26-49)."""
    plt = _pyplot()
    matrix = np.asarray(matrix)
    h, w = matrix.shape
    if h * w > maxNrPixels:
        step = int(np.ceil(h * w / maxNrPixels))
        wpad = int(np.ceil(w / step)) * step
        padded = np.full((h, wpad), matrix.min(), dtype=matrix.dtype)
        padded[:, :w] = matrix
        matrix = padded.reshape(h, -1, step).max(axis=2)
    plt.gca().imshow(matrix, cmap=cmap, norm=norm, **kwargs)


def sortMatrix(m, order):
    return np.asarray(m)[np.asarray(order)]


def sortByFrequency(m):
    """Row order by descending total frequency (plotting.py:68-78)."""
    totals = np.asarray(m).sum(axis=1)
    return np.argsort(-totals, kind="stable")


def sortMatrixByFrequency(m):
    return sortMatrix(m, sortByFrequency(m))


def plotMatrix(m, xlabel="Position along chromosome",
               ylabel="Marginal counts", xstretch=1, xmin=0,
               normalize=False, **kwargs):
    """Stacked imshow of a (rows, positions) matrix (plotting.py:89-106)."""
    plt = _pyplot()
    ax = plt.gca()
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ymax, xmax = np.asarray(m).shape
    if normalize:
        ymax = 1
    ext = [xmin, xmin + xmax * xstretch, 0, ymax]
    scaledImshow(
        m, extent=ext, aspect="auto", origin="lower", interpolation="none",
        **kwargs,
    )
    return ax


def matrixQuantilePlot(data, quantiles=range(5, 100, 5), xlabel="Iteration",
                       ylabel="Quantiles", cmap="Blues", mincolor=0.1,
                       maxcolor=0.9, ylim=None):
    """Quantile-band plot of a (samples, iterations) matrix: nested
    fill_betweens for symmetric quantile pairs with the median on top
    (plotting.py:115-185)."""
    plt = _pyplot()
    data = np.asarray(data)
    quantiles = list(quantiles)
    percentiles = np.percentile(data, quantiles, axis=0)
    iterations = data.shape[1]
    ax = plt.gca()
    colormap = plt.get_cmap(cmap)
    xs = np.arange(iterations)
    for i, q in enumerate(quantiles):
        if q == 50:
            ax.plot(
                xs, percentiles[i], color="black",
                zorder=len(quantiles), linewidth=2,
            )
        if q > 50:
            break
        color = colormap((q / 100) / (maxcolor - mincolor) + mincolor)
        ax.fill_between(
            xs, percentiles[i], percentiles[-i - 1], color=color,
            linewidth=1, zorder=i,
        )
        ax.plot(xs, percentiles[i], color="black", linewidth=0.3,
                zorder=len(quantiles) + 1)
        ax.plot(xs, percentiles[-i - 1], color="black", linewidth=0.3,
                zorder=len(quantiles) + 1)
    ymin = percentiles.min()
    ymax = percentiles.max()
    if ylim is not None:
        ymin = min(ymin, ylim[0])
        ymax = min(ymax, ylim[1])
    margin = (ymax - ymin) * 0.05
    ax.set_ylim([ymin - margin, ymax + margin])
    ax.set_xlim([-iterations / 20, iterations + iterations / 20])
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    return ax


def plotData(data, states=None, start=0, end=None, marker=".", linewidth=0,
             alpha=0.8, xlabel=None, ylabel=None, cmap=None, norm=None):
    """Scatter of the data slice, colored by a per-position state when
    given (plotting.py:195-229)."""
    plt = _pyplot()
    ax = plt.gca()
    data = np.asarray(data)
    if end is None:
        end = start + len(data)
    c = "k" if states is None else np.asarray(states)[start:end]
    ax.scatter(
        np.arange(start, end), data[start:end], c=c, marker=marker,
        linewidth=linewidth, alpha=alpha, cmap=cmap, norm=norm, s=4,
    )
    if xlabel:
        ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim([start, end])
    return ax


def plotBlockSizes(blocks, start=0, end=None, chunkSize=1, ylabel=None,
                   cmap=None, norm=None):
    """Heat map of per-sweep block sizes: each row one sweep, pixel value =
    size of the block covering the position (plotting.py:232-245)."""
    mat = np.asarray(blocks.decompress()).T  # (sweeps, T) block sizes
    if end is None:
        end = mat.shape[1]
    plotMatrix(
        mat[:, start:end].astype(float), xmin=start, xstretch=chunkSize,
        ylabel=ylabel or "Iterations", cmap=cmap, norm=norm,
    )


def plotMarginals(marginals, start=0, end=None, cmap=None, norm=None,
                  normalize=True, sort_states=True, ylabel=None):
    """Stacked per-position posterior mass, bottom-up in state order (or
    frequency order with sort_states=False): the reference's 'Msp'/'Mfc'
    subfigure families (plotResults:306-330, plotting.py:248-270)."""
    plt = _pyplot()
    counts = marginals.values()  # (segments, K)
    sizes = marginals.blocksizes()
    ax = plt.gca()
    T = int(sizes.sum())
    if end is None:
        end = T
    full = np.repeat(counts, sizes, axis=0)[start:end]  # (n, K)
    if not sort_states:
        order = sortByFrequency(full.T)
    else:
        order = np.arange(full.shape[1])
    vals = full[:, order].astype(float)
    if normalize:
        vals = vals / np.maximum(vals.sum(axis=1, keepdims=True), 1)
    xs = np.arange(start, end)
    bottom = np.zeros(end - start)
    cmap = cmap or plt.get_cmap("tab10")
    for j, s in enumerate(order):
        color = cmap(norm(s)) if norm is not None else cmap(int(s) % 10)
        ax.fill_between(
            xs, bottom, bottom + vals[:, j], color=color, linewidth=0,
        )
        bottom += vals[:, j]
    ax.set_xlim(start, end)
    ax.set_ylim(0, 1 if normalize else bottom.max())
    ax.set_ylabel(ylabel or "Marginal probabilities")
    return ax


def plotSequences(sequences, start=0, end=None, nrStates=None, cmap=None,
                  norm=None, ylabel=None):
    """Heat map of sampled state sequences, one row per recorded sweep
    (plotting.py:273-292)."""
    plt = _pyplot()
    if not sequences:
        return plt.gca()
    T = len(sequences[0])
    if end is None:
        end = T
    mat = np.stack([s.decompress()[start:end] for s in sequences])
    plotMatrix(
        mat, xmin=start, ylabel=ylabel or "Iterations", cmap=cmap, norm=norm,
    )
    return plt.gca()
