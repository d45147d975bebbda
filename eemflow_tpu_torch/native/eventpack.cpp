// Fused event decoder + packer — the port's native host-side input runtime
// (its own copy of eemflow_tpu/native/eventpack.cpp, same numerics).
//
// The reference feeds its GPU from torch DataLoader worker processes whose
// hot loop is pure Python/numpy event munging (npz columns → float64
// stack → scale → relative-time → voxelize; loader/loader_utils.py:26-42 +
// :352-397).  The port voxelizes on the card (kernel K1); what remains on
// the host is decode+pad — this translation unit fuses it into one pass
// with no intermediate arrays:
//
//   npz columns (t int64[ns], x int16, y int16, p int8 0/1)
//     → float32 [bucket, 4] rows (t_rel in µs-by-default, x, y, p ±1),
//       zero-padded, truncation counted.
//
// Numerics mirror the Python path exactly (events/io.py
// read_compressed_events + events/sequence.py EventSequence +
// events/voxel.py pad_events): t is scaled to seconds in double, then by
// ts_mult, then made relative to the first (sorted) timestamp, then cast
// to float32.  Returns 0 on success, 1 if the input is not time-sorted
// (caller falls back to the numpy path, which sorts).
//
// Built with plain g++ -O3 -shared -fPIC (native/__init__.py); bound via
// ctypes, a plain C ABI.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// t int64 nanoseconds (HREM npz layout)
int decode_pack_i64(const long long* t_ns, const short* x, const short* y,
                    const signed char* p, long long n, long long bucket,
                    double ts_mult, float* out, long long* n_valid,
                    long long* n_dropped) {
    for (long long i = 1; i < n; ++i)
        if (t_ns[i] < t_ns[i - 1]) return 1;  // unsorted → caller falls back

    const long long m = n < bucket ? n : bucket;
    double t0 = 0.0;
    if (n > 0) {
        t0 = static_cast<double>(t_ns[0]) * 1e-9;  // ns → s (reader)
        t0 *= ts_mult;                             // s → caller units
    }
    for (long long i = 0; i < m; ++i) {
        double v = static_cast<double>(t_ns[i]) * 1e-9;
        v *= ts_mult;
        float* row = out + 4 * i;
        row[0] = static_cast<float>(v - t0);
        row[1] = static_cast<float>(x[i]);
        row[2] = static_cast<float>(y[i]);
        row[3] = static_cast<float>(2 * static_cast<int>(p[i]) - 1);
    }
    if (m < bucket)
        std::memset(out + 4 * m, 0, sizeof(float) * 4 * (bucket - m));
    *n_valid = m;
    *n_dropped = n - m;
    return 0;
}

// generic float64 columns (MVSEC per-frame h5 tables: ts in s, p already ±1
// or 0/1 — map_zero_polarity selects the 0/1 → ±1 mapping)
int decode_pack_f64(const double* ts, const double* x, const double* y,
                    const double* p, long long n, long long bucket,
                    double ts_mult, int map_zero_polarity, float* out,
                    long long* n_valid, long long* n_dropped) {
    for (long long i = 1; i < n; ++i)
        if (ts[i] < ts[i - 1]) return 1;

    const long long m = n < bucket ? n : bucket;
    const double t0 = (n > 0) ? ts[0] * ts_mult : 0.0;
    for (long long i = 0; i < m; ++i) {
        float* row = out + 4 * i;
        row[0] = static_cast<float>(ts[i] * ts_mult - t0);
        row[1] = static_cast<float>(x[i]);
        row[2] = static_cast<float>(y[i]);
        double pol = p[i];
        if (map_zero_polarity && pol == 0.0) pol = -1.0;
        row[3] = static_cast<float>(pol);
    }
    if (m < bucket)
        std::memset(out + 4 * m, 0, sizeof(float) * 4 * (bucket - m));
    *n_valid = m;
    *n_dropped = n - m;
    return 0;
}

// Host voxelizer: packed event rows → [bins, H, W] float32 grid.
//
// Semantics mirror events_to_voxel_grid_np (events/voxel.py:244-290, the
// float64 host twin of the device scatter, itself reference-parity with
// loader/loader_utils.py:429-537): bilinear time binning, p==0 → −1,
// ΔT==0 → 1, out-of-frame events dropped, optional nonzero-cell
// mean/std(ddof=1) normalization (accumulated in double over the touched
// set, like the twin).
//
// Why this exists: a host CPU does the 2·N updates in O(N) cache-local
// stores; voxelizing on prefetch-thread cores leaves the device critical
// path at forward-only (the reference's own deployment shape — its
// DataLoader workers voxelize on CPU; `serve --host_voxelize`).
//
// Cost model: strictly O(events), never O(grid) — the grid is ~4.6 M
// cells at 720p×5 bins but carries ≤2·N nonzero cells (N≈6·10⁴), so all
// full-grid passes (zeroing, normalization scans) are replaced by a
// touched-cell index list.  The caller keeps `out` zeroed between calls
// by re-zeroing ONLY the touched cells of its previous use (zero_cells;
// the Python wrapper rings buffers), and `stamp`+`epoch` give O(1)
// first-touch detection without clearing the stamp grid.
//
// Returns the touched-cell count k (indices in touched[0..k)), or −1 if
// epoch is 0 (reserved: a zeroed stamp grid must never equal epoch).
long long voxelize_sparse(const float* rows /* [n,4] t,x,y,p (packed) */,
                          long long n, int num_bins, int height, int width,
                          int normalize,
                          int nhwc /* 1: [H,W,bins] layout (model input);
                                      0: [bins,H,W] */,
                          unsigned* stamp /* [cells], 0-init once */,
                          unsigned epoch /* unique per call, >0 */,
                          float* out /* [cells], zeroed on entry */,
                          long long* touched /* cap 2*n */) {
    if (epoch == 0) return -1;
    long long k = 0;
    if (n > 0) {
        const double t0 = rows[0];
        double deltaT = static_cast<double>(rows[4 * (n - 1)]) - t0;
        if (deltaT == 0.0) deltaT = 1.0;
        const double nb1 = static_cast<double>(num_bins - 1);
        const long long hw = static_cast<long long>(height) * width;
        for (long long i = 0; i < n; ++i) {
            const float* r = rows + 4 * i;
            const long long x = static_cast<long long>(r[1]);
            const long long y = static_cast<long long>(r[2]);
            if (x < 0 || x >= width || y < 0 || y >= height) continue;
            double pol = r[3];
            if (pol == 0.0) pol = -1.0;
            // same fp op order as the numpy twin: (nb·Δt)/ΔT, not Δt·(nb/ΔT)
            const double ts =
                nb1 * (static_cast<double>(r[0]) - t0) / deltaT;
            const double ti = std::floor(ts);
            const double dt = ts - ti;
            const long long tb = static_cast<long long>(ti);
            const long long base = nhwc ? (x + y * width) * num_bins
                                        : x + y * width;
            const long long stride = nhwc ? 1 : hw;
            if (ti >= 0.0 && ti < num_bins) {
                const long long c = base + tb * stride;
                if (stamp[c] != epoch) { stamp[c] = epoch; touched[k++] = c; }
                out[c] += static_cast<float>(pol * (1.0 - dt));
            }
            if (ti >= 0.0 && ti + 1 < num_bins) {
                const long long c = base + (tb + 1) * stride;
                if (stamp[c] != epoch) { stamp[c] = epoch; touched[k++] = c; }
                out[c] += static_cast<float>(pol * dt);
            }
        }
    }

    if (normalize && k > 0) {
        // nonzero-cell stats (touched cells that cancelled to 0 excluded,
        // matching the twin's `grid != 0` mask), double accumulation
        long long cnt = 0;
        double sum = 0.0;
        for (long long j = 0; j < k; ++j) {
            const float v = out[touched[j]];
            if (v != 0.0f) { ++cnt; sum += v; }
        }
        if (cnt > 0) {
            const double mean = sum / cnt;
            double var = 0.0;
            for (long long j = 0; j < k; ++j) {
                const float v = out[touched[j]];
                if (v != 0.0f) {
                    const double d = v - mean;
                    var += d * d;
                }
            }
            const double std =
                (cnt > 1) ? std::sqrt(var / (cnt - 1)) : 0.0;
            if (std > 0.0) {
                for (long long j = 0; j < k; ++j) {
                    const long long c = touched[j];
                    if (out[c] != 0.0f)
                        out[c] = static_cast<float>((out[c] - mean) / std);
                }
            } else {
                for (long long j = 0; j < k; ++j) {
                    const long long c = touched[j];
                    if (out[c] != 0.0f)
                        out[c] = static_cast<float>(out[c] - mean);
                }
            }
        }
    }
    return k;
}

// re-zero the cells a previous voxelize_sparse call touched (ring-buffer
// reuse without full-grid memsets)
void zero_cells(float* out, const long long* idx, long long k) {
    for (long long j = 0; j < k; ++j) out[idx[j]] = 0.0f;
}

}  // extern "C"
