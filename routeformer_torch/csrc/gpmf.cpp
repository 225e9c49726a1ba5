// Native GPMF (GoPro Metadata Format) GPS extractor.
//
// Plays the performance role of the reference's gopro2gpx parseStream +
// BuildGPSPoints path (reference routeformer/io/dataset.py:2387-2468), which
// walks multi-megabyte telemetry streams in pure Python per recording at
// dataset-index time. This C++ walker mirrors the semantics of
// routeformer_torch/io/gpmf.py's SCAL/GPSU/GPSF/GPSP/GPS5 finite-state
// machine (the Python implementation stays as the reference; parity is
// asserted in tests). The port's copy of the JAX package's native/gpmf.cpp.
// Timestamp *fixing* (the 18 Hz plausibility logic) stays in Python — it is
// O(#points) cheap.
//
// Build:  routeformer_torch/io/native.py, g++ -O3 -std=c++17 -shared -fPIC
// ABI  :  extern "C" gpmf_extract_gps(...)  (ctypes)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <ctime>

namespace {

inline uint16_t be16(const uint8_t* p) {
    return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

inline uint32_t be32(const uint8_t* p) {
    return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | static_cast<uint32_t>(p[3]);
}

inline int32_t be32s(const uint8_t* p) { return static_cast<int32_t>(be32(p)); }

inline bool printable4(const uint8_t* p) {
    for (int i = 0; i < 4; ++i) {
        if (p[i] < 0x20 || p[i] > 0x7e) return false;
    }
    return true;
}

// Parse the canonical GoPro GPSU text "yymmddhhmmss.<1-6 frac digits>"
// (NUL padding stripped) to posix seconds (UTC).
//
// Tri-state result, mirroring io/gpmf.py exactly:
//   PARSED   — text matches the canonical shape and is calendar-valid
//   INVALID  — canonical shape but calendar-invalid (Python's strptime
//              raises -> the item yields gpsu=None); report NaN
//   BAILOUT  — any other shape: the Python strptime grammar is not worth
//              replicating here; the caller falls back to the Python FSM
enum class GpsuResult { PARSED, INVALID, BAILOUT };

GpsuResult parse_gpsu(const uint8_t* p, long len, double* out) {
    *out = NAN;
    while (len > 0 && p[len - 1] == 0) --len;  // Python rstrip("\x00")
    if (len < 14 || len > 19) return GpsuResult::BAILOUT;
    for (int i = 0; i < 12; ++i)
        if (p[i] < '0' || p[i] > '9') return GpsuResult::BAILOUT;
    if (p[12] != '.') return GpsuResult::BAILOUT;
    double frac = 0.0, scale = 0.1;
    for (long i = 13; i < len; ++i) {
        if (p[i] < '0' || p[i] > '9') return GpsuResult::BAILOUT;
        frac += (p[i] - '0') * scale;
        scale *= 0.1;
    }
    auto two = [&](int i) { return (p[i] - '0') * 10 + (p[i + 1] - '0'); };
    struct tm t;
    std::memset(&t, 0, sizeof(t));
    t.tm_year = 100 + two(0);  // 20yy
    t.tm_mon = two(2) - 1;
    t.tm_mday = two(4);
    t.tm_hour = two(6);
    t.tm_min = two(8);
    t.tm_sec = two(10);
    struct tm want = t;
    time_t secs = timegm(&t);
    if (secs == static_cast<time_t>(-1)) return GpsuResult::INVALID;
    // timegm NORMALIZES out-of-range fields (month 13 -> next January);
    // Python's datetime raises instead. Round-trip to detect normalization.
    struct tm back;
    if (gmtime_r(&secs, &back) == nullptr) return GpsuResult::INVALID;
    if (back.tm_year != want.tm_year || back.tm_mon != want.tm_mon ||
        back.tm_mday != want.tm_mday || back.tm_hour != want.tm_hour ||
        back.tm_min != want.tm_min || back.tm_sec != want.tm_sec) {
        return GpsuResult::INVALID;
    }
    *out = static_cast<double>(secs) + frac;
    return GpsuResult::PARSED;
}

constexpr int kMaxDepth = 512;  // pathological nesting -> Python fallback

struct State {
    // scal mirrors the Python tuple: n_scal values, missing indices fall
    // back to scal[0] (io/gpmf.py: "scal[k] if len(scal) > k else scal[0]")
    double scal[5] = {1, 1, 1, 1, 1};
    int n_scal = 5;
    double gpsu = NAN;      // pending batch timestamp
    bool has_gpsu = false;
    double gpsp = NAN;      // dilution of precision
    bool has_gpsp = false;
    double gpsfix = 0.0;    // whole-valued; only compared against 0
    bool bailout = false;   // non-canonical stream: caller must use Python
    // outputs
    double* out;            // (max_points, 5): lat, lon, alt, speed2d, dop
    double* out_time;       // (max_points,)
    long count = 0;
    long max_points = 0;
};

// Read the first scalar of a typed payload for the canonical integer
// types; anything else is non-canonical -> bailout.
bool read_scalar(uint8_t type, uint8_t struct_size, long length,
                 const uint8_t* payload, double* out) {
    if (type == 'L' && struct_size == 4 && length >= 4) {
        *out = static_cast<double>(be32(payload));
        return true;
    }
    if (type == 'l' && struct_size == 4 && length >= 4) {
        *out = static_cast<double>(be32s(payload));
        return true;
    }
    if (type == 'S' && struct_size == 2 && length >= 2) {
        *out = static_cast<double>(be16(payload));
        return true;
    }
    if (type == 's' && struct_size == 2 && length >= 2) {
        *out = static_cast<double>(static_cast<int16_t>(be16(payload)));
        return true;
    }
    return false;
}

void walk(const uint8_t* data, long size, State& st, int depth) {
    if (depth > kMaxDepth) {
        st.bailout = true;
        return;
    }
    long pos = 0;
    while (pos + 8 <= size && !st.bailout) {
        const uint8_t* hdr = data + pos;
        if (!printable4(hdr)) {  // resync, matching the Python parser
            pos += 4;
            continue;
        }
        uint8_t type = hdr[4];
        uint8_t struct_size = hdr[5];
        uint16_t repeat = be16(hdr + 6);
        long length = static_cast<long>(struct_size) * repeat;
        long padded = (length + 3) & ~3L;
        if (pos + 8 + length > size) {
            pos += 4;
            continue;
        }
        const uint8_t* payload = data + pos + 8;
        uint32_t fourcc = be32(hdr);

        if (type == 0) {  // nested container
            walk(payload, length, st, depth + 1);
        } else if (fourcc == 0x5343414cu) {  // 'SCAL'
            // canonical: 'l' (4-byte signed) or 's' (2-byte signed) with a
            // struct size that is a whole number of elements (the Python
            // FSM ignores leftover bytes only per row; mismatched strides
            // diverge -> bailout)
            int elem = (type == 'l') ? 4 : (type == 's') ? 2 : 0;
            if (elem == 0 || struct_size % elem != 0) {
                st.bailout = true;
                break;
            }
            int n = 0;
            // only the first 4 scale values are ever consumed; cap at 5
            for (long off = 0; off + elem <= length && n < 5; off += elem) {
                st.scal[n++] =
                    (elem == 4)
                        ? static_cast<double>(be32s(payload + off))
                        : static_cast<double>(
                              static_cast<int16_t>(be16(payload + off)));
            }
            if (n > 0) st.n_scal = n;
            // NOTE: empty SCAL (repeat 0) keeps the previous scale, like
            // the Python "malformed SCAL, keeping previous" path.
        } else if (fourcc == 0x47505355u) {  // 'GPSU'
            if (type != 'U') {
                st.bailout = true;
                break;
            }
            double t;
            GpsuResult r = parse_gpsu(payload, length, &t);
            if (r == GpsuResult::BAILOUT) {
                st.bailout = true;
                break;
            }
            st.gpsu = t;
            st.has_gpsu = (r == GpsuResult::PARSED);
        } else if (fourcc == 0x47505346u) {  // 'GPSF'
            double v;
            if (!read_scalar(type, struct_size, length, payload, &v)) {
                st.bailout = true;
                break;
            }
            st.gpsfix = v;
        } else if (fourcc == 0x47505350u) {  // 'GPSP'
            double v;
            if (!read_scalar(type, struct_size, length, payload, &v)) {
                st.bailout = true;
                break;
            }
            st.gpsp = v;
            st.has_gpsp = true;
        } else if (fourcc == 0x47505335u) {  // 'GPS5'
            if (type != 'l') {  // canonical GPS5 is signed 32-bit rows
                st.bailout = true;
                break;
            }
            int per_row = struct_size / 4;
            // effective scales with the Python fallback-to-scal[0] rule
            double s_lat = st.n_scal > 0 ? st.scal[0] : 0.0;
            double s_lon = st.n_scal > 1 ? st.scal[1] : s_lat;
            double s_alt = st.n_scal > 2 ? st.scal[2] : s_lat;
            double s_spd = st.n_scal > 3 ? st.scal[3] : s_lat;
            if (s_lat == 0.0 || s_lon == 0.0 || s_alt == 0.0 || s_spd == 0.0) {
                // zero/empty SCAL -> skip the whole batch (gpsu NOT consumed)
                pos += 8 + padded;
                continue;
            }
            for (int r = 0; r < repeat; ++r) {
                const uint8_t* row = payload + static_cast<long>(r) * struct_size;
                if (per_row < 5) break;
                int32_t lat_r = be32s(row);
                int32_t lon_r = be32s(row + 4);
                int32_t alt_r = be32s(row + 8);
                int32_t s2d_r = be32s(row + 12);
                if (lat_r == 0 && lon_r == 0 && alt_r == 0) continue;  // empty fix
                double lat = lat_r / s_lat;
                double lon = lon_r / s_lon;
                if (!std::isfinite(lat) || !std::isfinite(lon)) continue;
                if (st.count >= st.max_points) {  // cannot represent: fallback
                    st.bailout = true;
                    return;
                }
                double* o = st.out + st.count * 5;
                o[0] = lat;
                o[1] = lon;
                o[2] = alt_r / s_alt;
                o[3] = s2d_r / s_spd;
                o[4] = (st.gpsfix == 0.0 || !st.has_gpsp) ? INFINITY : st.gpsp;
                st.out_time[st.count] =
                    st.has_gpsu ? st.gpsu : NAN;  // GPSU stamps batch head only
                st.has_gpsu = false;
                ++st.count;
            }
        }
        pos += 8 + padded;
    }
}

}  // namespace

extern "C" {

// Returns the number of GPS points written (<= max_points), or -1 when the
// stream is non-canonical and the caller must fall back to the Python FSM
// (io/gpmf.py) for exact semantics.
// out:      caller-allocated (max_points * 5) doubles [lat, lon, alt, speed2d, dop]
// out_time: caller-allocated (max_points) doubles, posix seconds or NaN
long gpmf_extract_gps(const uint8_t* data, long size, double* out,
                      double* out_time, long max_points) {
    State st;
    st.out = out;
    st.out_time = out_time;
    st.max_points = max_points;
    walk(data, size, st, 0);
    return st.bailout ? -1 : st.count;
}

int gpmf_native_abi_version() { return 2; }

}  // extern "C"
