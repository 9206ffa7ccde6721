// Native ASTM E2807 (.e57) container reader of rtnr_tpu_torch's host library
// (C ABI / ctypes, bound in data/native.py).
//
// Scope-parity with the reference's libE57Format usage
// (reference src/RTRenderer/src/PointCloudReader.cpp:116-294): multi-scan
// point reads (cartesian + spherical + invalid states + colors), per-scan
// rigid pose, color limits, and embedded 2D images (jpeg blob + pinhole
// intrinsics + pose, PointCloudReader.cpp:18-51). Implemented from the
// E2807 container spec — NOT a port of libE57Format:
//
//   - file header (48 bytes: "ASTM-E57", versions, physical length,
//     xmlPhysicalOffset, xmlLogicalLength, pageSize)
//   - CRC-paged physical layout: every 1024-byte page carries 1020 payload
//     bytes + CRC-32C (Castagnoli) of the payload; "logical" offsets skip
//     the CRC words
//   - XML section describing the element tree (minimal pull parser below;
//     handles elements/attributes/text/CDATA — the E57 XML subset)
//   - CompressedVector binary sections: 32-byte section header, then data
//     packets (type 1) each holding one byte-range chunk per field
//     bytestream; Integer/ScaledInteger fields are bitpack-coded
//     (LSB-first, (value - minimum) in ceil(log2(max-min+1)) bits, bit
//     state carried across packet chunks), Float fields raw IEEE LE
//   - Blob sections (16-byte header + raw bytes) for jpeg images
//
// API style: e57_open parses header+XML and returns a handle; e57_meta
// returns a JSON description (scans, fields, poses, limits, images);
// field/blob reads fill caller-allocated numpy buffers (all point fields
// decode to f64, matching libE57's doConversion=true behavior that the
// reference relies on).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace e57r {

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli, reflected poly 0x82F63B78) — the page checksum.
// ---------------------------------------------------------------------------
struct Crc32c {
  uint32_t table[256];
  Crc32c() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
  }
  uint32_t compute(const uint8_t* p, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i) c = table[(c ^ p[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }
};
static const Crc32c kCrc;

constexpr uint64_t kPage = 1024;
constexpr uint64_t kPayload = 1020;

// ---------------------------------------------------------------------------
// Paged file: whole-file buffer + logical (CRC-skipping) reads.
// ---------------------------------------------------------------------------
struct PagedFile {
  std::vector<uint8_t> raw;
  std::string error;

  bool load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) { error = "cannot open file"; return false; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    raw.resize((size_t)sz);
    bool ok = sz == 0 || fread(raw.data(), 1, (size_t)sz, f) == (size_t)sz;
    fclose(f);
    if (!ok) { error = "short read"; return false; }
    if (raw.size() < 48 || memcmp(raw.data(), "ASTM-E57", 8) != 0) {
      error = "not an ASTM-E57 file";
      return false;
    }
    if (raw.size() % kPage != 0) { error = "file not page-aligned"; return false; }
    for (size_t off = 0; off < raw.size(); off += kPage) {
      uint32_t want;
      memcpy(&want, raw.data() + off + kPayload, 4);
      if (kCrc.compute(raw.data() + off, kPayload) != want) {
        error = "page CRC mismatch at offset " + std::to_string(off);
        return false;
      }
    }
    return true;
  }

  uint64_t logicalSize() const { return (raw.size() / kPage) * kPayload; }

  static uint64_t physicalToLogical(uint64_t p) {
    return (p / kPage) * kPayload + (p % kPage);
  }

  // Copy `n` logical bytes starting at logical offset `lo` into dst.
  bool readLogical(uint64_t lo, uint64_t n, uint8_t* dst) const {
    if (lo + n > logicalSize()) return false;
    while (n > 0) {
      uint64_t page = lo / kPayload, in = lo % kPayload;
      uint64_t take = kPayload - in;
      if (take > n) take = n;
      memcpy(dst, raw.data() + page * kPage + in, (size_t)take);
      dst += take;
      lo += take;
      n -= take;
    }
    return true;
  }

  template <typename T>
  bool readScalar(uint64_t lo, T* out) const {
    return readLogical(lo, sizeof(T), reinterpret_cast<uint8_t*>(out));
  }
};

// ---------------------------------------------------------------------------
// Minimal XML tree parser (elements, attributes, text, CDATA, comments).
// ---------------------------------------------------------------------------
struct XmlNode {
  std::string name;
  std::map<std::string, std::string> attrs;
  std::vector<std::unique_ptr<XmlNode>> children;
  std::string text;

  const XmlNode* child(const std::string& n) const {
    for (auto& c : children)
      if (c->name == n) return c.get();
    return nullptr;
  }
  std::string attr(const std::string& n, const std::string& dflt = "") const {
    auto it = attrs.find(n);
    return it == attrs.end() ? dflt : it->second;
  }
  double number(double dflt = 0.0) const {
    return text.empty() ? dflt : strtod(text.c_str(), nullptr);
  }
  // typed child accessors (E57 encodes scalars as element text)
  double childNum(const std::string& n, double dflt = 0.0) const {
    const XmlNode* c = child(n);
    return c ? c->number(dflt) : dflt;
  }
};

struct XmlParser {
  const char* p;
  const char* end;
  std::string error;

  explicit XmlParser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void skipWs() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool literal(const char* s) {
    size_t n = strlen(s);
    if ((size_t)(end - p) < n || strncmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  std::string name() {
    const char* s = p;
    while (p < end && (isalnum((unsigned char)*p) || *p == '_' || *p == ':' ||
                       *p == '-' || *p == '.'))
      ++p;
    return std::string(s, p);
  }

  std::unique_ptr<XmlNode> parse() {
    skipWs();
    // prolog / comments / processing instructions
    while (p < end && literal("<?")) {
      while (p < end && !literal("?>")) ++p;
      skipWs();
    }
    while (p < end && literal("<!--")) {
      while (p < end && !literal("-->")) ++p;
      skipWs();
    }
    return element();
  }

  std::unique_ptr<XmlNode> element() {
    skipWs();
    if (p >= end || *p != '<') { error = "expected '<'"; return nullptr; }
    ++p;
    auto node = std::make_unique<XmlNode>();
    node->name = name();
    if (node->name.empty()) { error = "empty element name"; return nullptr; }
    // attributes
    for (;;) {
      skipWs();
      if (p < end && literal("/>")) return node;
      if (p < end && *p == '>') { ++p; break; }
      std::string an = name();
      if (an.empty()) { error = "bad attribute in <" + node->name + ">"; return nullptr; }
      skipWs();
      if (p >= end || *p != '=') { error = "expected '='"; return nullptr; }
      ++p;
      skipWs();
      if (p >= end || (*p != '"' && *p != '\'')) { error = "expected quote"; return nullptr; }
      char q = *p++;
      const char* s = p;
      while (p < end && *p != q) ++p;
      node->attrs[an] = std::string(s, p);
      if (p < end) ++p;
    }
    // content
    for (;;) {
      if (p >= end) { error = "unterminated <" + node->name + ">"; return nullptr; }
      if (*p == '<') {
        if (literal("<![CDATA[")) {
          const char* s = p;
          while (p < end && !(end - p >= 3 && p[0] == ']' && p[1] == ']' && p[2] == '>')) ++p;
          node->text.append(s, p);
          p += 3;
          continue;
        }
        if (literal("<!--")) {
          while (p < end && !literal("-->")) ++p;
          continue;
        }
        if (end - p >= 2 && p[1] == '/') {
          p += 2;
          std::string n = name();
          skipWs();
          if (p < end && *p == '>') ++p;
          if (n != node->name) { error = "mismatched </" + n + ">"; return nullptr; }
          return node;
        }
        auto c = element();
        if (!c) return nullptr;
        node->children.push_back(std::move(c));
      } else {
        const char* s = p;
        while (p < end && *p != '<') ++p;
        node->text.append(s, p);
      }
    }
  }
};

// trim whitespace (element text holds numbers padded by pretty-printing)
static std::string trim(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\n\r");
  if (a == std::string::npos) return "";
  size_t b = s.find_last_not_of(" \t\n\r");
  return s.substr(a, b - a + 1);
}

// ---------------------------------------------------------------------------
// Field prototypes + bitpack decoding
// ---------------------------------------------------------------------------
enum class FieldType { FloatSingle, FloatDouble, Integer, ScaledInteger };

struct Field {
  std::string name;
  FieldType type;
  int64_t minimum = 0, maximum = 0;  // Integer/ScaledInteger
  double scale = 1.0, offset = 0.0;  // ScaledInteger
  int bits = 0;                      // bitpack width

  static int bitWidth(uint64_t range) {
    int b = 0;
    while (range > 0) { ++b; range >>= 1; }
    return b;
  }
};

// Streaming decoder: consumes per-packet byte chunks, emits f64 records.
// Integer bit state carries across chunk boundaries (the bitstream is
// continuous; packets split it at byte granularity).
struct FieldDecoder {
  const Field& f;
  std::vector<double>& out;
  uint64_t want;          // total records
  uint64_t have = 0;      // decoded so far
  // float partial-record carry (a 4/8-byte value may straddle chunks)
  uint8_t carry[8];
  int carryLen = 0;
  // integer bit buffer
  uint64_t bitBuf = 0;
  int bitCnt = 0;

  FieldDecoder(const Field& field, std::vector<double>& o, uint64_t n)
      : f(field), out(o), want(n) {}

  void feed(const uint8_t* p, size_t n) {
    if (f.type == FieldType::FloatSingle || f.type == FieldType::FloatDouble) {
      const int w = f.type == FieldType::FloatSingle ? 4 : 8;
      size_t i = 0;
      while (have < want && i < n) {
        while (carryLen < w && i < n) carry[carryLen++] = p[i++];
        if (carryLen < w) return;
        if (w == 4) {
          float v;
          memcpy(&v, carry, 4);
          out.push_back((double)v);
        } else {
          double v;
          memcpy(&v, carry, 8);
          out.push_back(v);
        }
        carryLen = 0;
        ++have;
      }
      return;
    }
    // bitpack integers, LSB-first
    if (f.bits == 0) {  // constant field (minimum == maximum): no bits coded
      while (have < want) {
        out.push_back(decodeRaw(0));
        ++have;
      }
      return;
    }
    const uint64_t mask = (f.bits >= 64) ? ~0ull : ((1ull << f.bits) - 1);
    size_t i = 0;
    for (;;) {
      while (bitCnt < f.bits && i < n) {
        bitBuf |= (uint64_t)p[i++] << bitCnt;
        bitCnt += 8;
      }
      if (bitCnt < f.bits || have >= want) return;
      uint64_t raw = bitBuf & mask;
      bitBuf >>= f.bits;
      bitCnt -= f.bits;
      out.push_back(decodeRaw(raw));
      if (++have == want) return;
    }
  }

  double decodeRaw(uint64_t raw) const {
    int64_t v = f.minimum + (int64_t)raw;
    if (f.type == FieldType::ScaledInteger) return (double)v * f.scale + f.offset;
    return (double)v;
  }
};

// ---------------------------------------------------------------------------
// Parsed file model
// ---------------------------------------------------------------------------
struct Pose {
  bool present = false;
  double q[4] = {1, 0, 0, 0};  // w x y z
  double t[3] = {0, 0, 0};
};

struct Scan {
  std::string name, guid;
  uint64_t recordCount = 0;
  uint64_t sectionPhysical = 0;  // CompressedVector fileOffset
  std::vector<Field> fields;
  Pose pose;
  std::map<std::string, double> colorLimits;
  std::map<std::string, double> intensityLimits;
};

struct Image2D {
  std::string name, guid, representation;  // "pinhole" | "visualReference" | "spherical"
  Pose pose;
  uint64_t blobPhysical = 0;  // jpeg/png blob section fileOffset
  uint64_t blobLength = 0;
  bool isJpeg = true;
  int64_t imageWidth = 0, imageHeight = 0;
  double focalLength = 0, pixelWidth = 0, pixelHeight = 0;
  double principalPointX = 0, principalPointY = 0;
};

struct E57File {
  PagedFile file;
  std::unique_ptr<XmlNode> root;
  std::vector<Scan> scans;
  std::vector<Image2D> images;
  std::string meta;  // cached JSON
  std::string error;

  bool open(const char* path);
  bool parseTree();
  int readField(int scan, const char* field, double* out);
  int readBlob(int image, uint8_t* out);
};

static Pose parsePose(const XmlNode* n) {
  Pose p;
  if (!n) return p;
  p.present = true;
  if (const XmlNode* r = n->child("rotation")) {
    p.q[0] = r->childNum("w", 1.0);
    p.q[1] = r->childNum("x");
    p.q[2] = r->childNum("y");
    p.q[3] = r->childNum("z");
  }
  if (const XmlNode* t = n->child("translation")) {
    p.t[0] = t->childNum("x");
    p.t[1] = t->childNum("y");
    p.t[2] = t->childNum("z");
  }
  return p;
}

bool E57File::open(const char* path) {
  if (!file.load(path)) { error = file.error; return false; }
  // header: 8s sig, 2x u32 version, u64 physLength, u64 xmlPhysOffset,
  // u64 xmlLogicalLength, u64 pageSize
  uint64_t xmlPhys, xmlLen, pageSize;
  memcpy(&xmlPhys, file.raw.data() + 24, 8);
  memcpy(&xmlLen, file.raw.data() + 32, 8);
  memcpy(&pageSize, file.raw.data() + 40, 8);
  if (pageSize != kPage) { error = "unsupported page size"; return false; }
  std::string xml(xmlLen, '\0');
  if (!file.readLogical(PagedFile::physicalToLogical(xmlPhys), xmlLen,
                        reinterpret_cast<uint8_t*>(&xml[0]))) {
    error = "XML section out of range";
    return false;
  }
  XmlParser parser(xml);
  root = parser.parse();
  if (!root) { error = "XML parse error: " + parser.error; return false; }
  return parseTree();
}

static void parsePrototype(const XmlNode* proto, Scan* s) {
  for (auto& c : proto->children) {
    Field f;
    f.name = c->name;
    std::string t = c->attr("type");
    if (t == "Float") {
      f.type = c->attr("precision") == "single" ? FieldType::FloatSingle
                                                : FieldType::FloatDouble;
    } else if (t == "Integer" || t == "ScaledInteger") {
      f.type = t == "Integer" ? FieldType::Integer : FieldType::ScaledInteger;
      f.minimum = strtoll(c->attr("minimum", "0").c_str(), nullptr, 10);
      f.maximum = strtoll(c->attr("maximum", "0").c_str(), nullptr, 10);
      f.scale = strtod(c->attr("scale", "1").c_str(), nullptr);
      f.offset = strtod(c->attr("offset", "0").c_str(), nullptr);
      f.bits = Field::bitWidth((uint64_t)(f.maximum - f.minimum));
    } else {
      continue;  // String etc. — not used by point prototypes we consume
    }
    s->fields.push_back(f);
  }
}

bool E57File::parseTree() {
  if (const XmlNode* d3 = root->child("data3D")) {
    for (auto& c : d3->children) {
      Scan s;
      if (const XmlNode* n = c->child("name")) s.name = trim(n->text);
      if (const XmlNode* g = c->child("guid")) s.guid = trim(g->text);
      s.pose = parsePose(c->child("pose"));
      const XmlNode* pts = c->child("points");
      if (!pts || pts->attr("type") != "CompressedVector") continue;
      s.recordCount = strtoull(pts->attr("recordCount", "0").c_str(), nullptr, 10);
      s.sectionPhysical = strtoull(pts->attr("fileOffset", "0").c_str(), nullptr, 10);
      if (const XmlNode* proto = pts->child("prototype")) parsePrototype(proto, &s);
      if (const XmlNode* cl = c->child("colorLimits"))
        for (auto& lim : cl->children) s.colorLimits[lim->name] = lim->number();
      if (const XmlNode* il = c->child("intensityLimits"))
        for (auto& lim : il->children) s.intensityLimits[lim->name] = lim->number();
      scans.push_back(std::move(s));
    }
  }
  if (const XmlNode* i2 = root->child("images2D")) {
    for (auto& c : i2->children) {
      Image2D im;
      if (const XmlNode* n = c->child("name")) im.name = trim(n->text);
      if (const XmlNode* g = c->child("guid")) im.guid = trim(g->text);
      im.pose = parsePose(c->child("pose"));
      const XmlNode* rep = c->child("pinholeRepresentation");
      im.representation = "pinhole";
      if (!rep) { rep = c->child("visualReferenceRepresentation"); im.representation = "visualReference"; }
      if (!rep) { rep = c->child("sphericalRepresentation"); im.representation = "spherical"; }
      if (!rep) continue;
      const XmlNode* blob = rep->child("jpegImageBlob");
      im.isJpeg = blob != nullptr;
      if (!blob) blob = rep->child("pngImageBlob");
      if (!blob) continue;
      im.blobPhysical = strtoull(blob->attr("fileOffset", "0").c_str(), nullptr, 10);
      im.blobLength = strtoull(blob->attr("length", "0").c_str(), nullptr, 10);
      im.imageWidth = strtoll(rep->child("imageWidth") ? trim(rep->child("imageWidth")->text).c_str() : "0", nullptr, 10);
      im.imageHeight = strtoll(rep->child("imageHeight") ? trim(rep->child("imageHeight")->text).c_str() : "0", nullptr, 10);
      im.focalLength = rep->childNum("focalLength");
      im.pixelWidth = rep->childNum("pixelWidth");
      im.pixelHeight = rep->childNum("pixelHeight");
      im.principalPointX = rep->childNum("principalPointX");
      im.principalPointY = rep->childNum("principalPointY");
      images.push_back(std::move(im));
    }
  }
  return true;
}

// Decode ALL fields of a scan once, returning the requested one. Packets
// interleave every field's bytestream, so a single-field read still walks
// the whole section; scans are decoded on demand and cached.
struct DecodedScan {
  std::map<std::string, std::vector<double>> cols;
};

static bool decodeScan(const PagedFile& file, const Scan& s, DecodedScan* out,
                       std::string* error) {
  uint64_t lo = PagedFile::physicalToLogical(s.sectionPhysical);
  uint8_t sectionId;
  if (!file.readScalar(lo, &sectionId) || sectionId != 1) {
    *error = "bad CompressedVector section header";
    return false;
  }
  uint64_t sectionLogicalLength, dataPhysical;
  file.readScalar(lo + 8, &sectionLogicalLength);
  file.readScalar(lo + 16, &dataPhysical);
  // (indexPhysicalOffset at +24 — unused: we stream packets sequentially)
  uint64_t sectionEnd = lo + sectionLogicalLength;

  std::vector<std::vector<double>> data(s.fields.size());
  std::vector<FieldDecoder> dec;
  dec.reserve(s.fields.size());
  for (size_t i = 0; i < s.fields.size(); ++i) {
    data[i].reserve(s.recordCount);
    dec.emplace_back(s.fields[i], data[i], s.recordCount);
  }

  uint64_t at = PagedFile::physicalToLogical(dataPhysical);
  std::vector<uint8_t> pkt;
  auto done = [&]() {
    for (auto& d : dec)
      if (d.have < d.want) return false;
    return true;
  };
  while (!done() && at < sectionEnd) {
    uint8_t type;
    if (!file.readScalar(at, &type)) { *error = "packet read out of range"; return false; }
    uint16_t lenMinus1;
    file.readScalar(at + 2, &lenMinus1);
    uint64_t pktLen = (uint64_t)lenMinus1 + 1;
    if (type != 1) { at += pktLen; continue; }  // index/empty packet: skip
    pkt.resize(pktLen);
    if (!file.readLogical(at, pktLen, pkt.data())) { *error = "packet read out of range"; return false; }
    uint16_t nStreams;
    memcpy(&nStreams, pkt.data() + 4, 2);
    if (nStreams != s.fields.size()) { *error = "bytestream count mismatch"; return false; }
    size_t hdr = 6 + 2ull * nStreams;
    size_t off = hdr;
    for (uint16_t i = 0; i < nStreams; ++i) {
      uint16_t blen;
      memcpy(&blen, pkt.data() + 6 + 2ull * i, 2);
      if (off + blen > pktLen) { *error = "bytestream overruns packet"; return false; }
      dec[i].feed(pkt.data() + off, blen);
      off += blen;
    }
    at += pktLen;
  }
  if (!done()) { *error = "compressed vector ended before recordCount records"; return false; }
  for (size_t i = 0; i < s.fields.size(); ++i)
    out->cols[s.fields[i].name] = std::move(data[i]);
  return true;
}

// ---------------------------------------------------------------------------
// JSON metadata (hand-rolled writer; numbers via %.17g round-trip)
// ---------------------------------------------------------------------------
static void jnum(std::string* s, double v) {
  char buf[40];
  snprintf(buf, sizeof buf, "%.17g", v);
  // JSON has no inf/nan
  if (strstr(buf, "inf") || strstr(buf, "nan")) strcpy(buf, "0");
  *s += buf;
}

static void jstr(std::string* s, const std::string& v) {
  *s += '"';
  for (char c : v) {
    if (c == '"' || c == '\\') { *s += '\\'; *s += c; }
    else if ((unsigned char)c >= 0x20) *s += c;
  }
  *s += '"';
}

static void jpose(std::string* s, const Pose& p) {
  *s += "{\"present\":";
  *s += p.present ? "true" : "false";
  *s += ",\"quaternion\":[";
  for (int i = 0; i < 4; ++i) { if (i) *s += ','; jnum(s, p.q[i]); }
  *s += "],\"translation\":[";
  for (int i = 0; i < 3; ++i) { if (i) *s += ','; jnum(s, p.t[i]); }
  *s += "]}";
}

static std::string buildMeta(const E57File& f) {
  std::string s = "{\"scans\":[";
  for (size_t i = 0; i < f.scans.size(); ++i) {
    const Scan& sc = f.scans[i];
    if (i) s += ',';
    s += "{\"name\":";
    jstr(&s, sc.name);
    s += ",\"guid\":";
    jstr(&s, sc.guid);
    s += ",\"record_count\":" + std::to_string(sc.recordCount);
    s += ",\"fields\":[";
    for (size_t j = 0; j < sc.fields.size(); ++j) {
      if (j) s += ',';
      jstr(&s, sc.fields[j].name);
    }
    s += "],\"pose\":";
    jpose(&s, sc.pose);
    s += ",\"color_limits\":{";
    bool first = true;
    for (auto& kv : sc.colorLimits) {
      if (!first) s += ',';
      first = false;
      jstr(&s, kv.first);
      s += ':';
      jnum(&s, kv.second);
    }
    s += "},\"intensity_limits\":{";
    first = true;
    for (auto& kv : sc.intensityLimits) {
      if (!first) s += ',';
      first = false;
      jstr(&s, kv.first);
      s += ':';
      jnum(&s, kv.second);
    }
    s += "}}";
  }
  s += "],\"images\":[";
  for (size_t i = 0; i < f.images.size(); ++i) {
    const Image2D& im = f.images[i];
    if (i) s += ',';
    s += "{\"name\":";
    jstr(&s, im.name);
    s += ",\"representation\":";
    jstr(&s, im.representation);
    s += ",\"jpeg\":";
    s += im.isJpeg ? "true" : "false";
    s += ",\"blob_length\":" + std::to_string(im.blobLength);
    s += ",\"image_width\":" + std::to_string(im.imageWidth);
    s += ",\"image_height\":" + std::to_string(im.imageHeight);
    s += ",\"focal_length\":";
    jnum(&s, im.focalLength);
    s += ",\"pixel_width\":";
    jnum(&s, im.pixelWidth);
    s += ",\"pixel_height\":";
    jnum(&s, im.pixelHeight);
    s += ",\"principal_point_x\":";
    jnum(&s, im.principalPointX);
    s += ",\"principal_point_y\":";
    jnum(&s, im.principalPointY);
    s += ",\"pose\":";
    jpose(&s, im.pose);
    s += '}';
  }
  s += "]}";
  return s;
}

struct Handle {
  E57File f;
  std::map<int, DecodedScan> cache;
};

int E57File::readBlob(int image, uint8_t* out) {
  if (image < 0 || (size_t)image >= images.size()) return 2;
  const Image2D& im = images[image];
  uint64_t lo = PagedFile::physicalToLogical(im.blobPhysical);
  uint8_t sectionId;
  if (!file.readScalar(lo, &sectionId) || sectionId != 0) return 3;
  // header: u8 id, u8[7] reserved, u64 sectionLogicalLength; blob follows
  return file.readLogical(lo + 16, im.blobLength, out) ? 0 : 4;
}

}  // namespace e57r

extern "C" {

// Open + parse. Returns a handle, or null (use e57_last_error for cause).
static thread_local std::string g_e57_error;

void* e57_open(const char* path) {
  auto* h = new e57r::Handle();
  if (!h->f.open(path)) {
    g_e57_error = h->f.error;
    delete h;
    return nullptr;
  }
  h->f.meta = e57r::buildMeta(h->f);
  return h;
}

const char* e57_last_error() { return g_e57_error.c_str(); }

void e57_close(void* h) { delete static_cast<e57r::Handle*>(h); }

// JSON metadata string (owned by the handle; valid until e57_close).
const char* e57_meta(void* hv) {
  return static_cast<e57r::Handle*>(hv)->f.meta.c_str();
}

// Decode one field of one scan into out (recordCount doubles). The whole
// scan decodes on first touch and is cached on the handle.
int e57_read_field_f64(void* hv, int scan, const char* field, double* out) {
  auto* h = static_cast<e57r::Handle*>(hv);
  if (scan < 0 || (size_t)scan >= h->f.scans.size()) return 2;
  auto it = h->cache.find(scan);
  if (it == h->cache.end()) {
    e57r::DecodedScan d;
    if (!e57r::decodeScan(h->f.file, h->f.scans[scan], &d, &g_e57_error)) return 3;
    it = h->cache.emplace(scan, std::move(d)).first;
  }
  auto cit = it->second.cols.find(field);
  if (cit == it->second.cols.end()) return 4;
  memcpy(out, cit->second.data(), cit->second.size() * sizeof(double));
  return 0;
}

// Copy an image's blob bytes (blob_length from e57_meta) into out.
int e57_read_blob(void* hv, int image, unsigned char* out) {
  return static_cast<e57r::Handle*>(hv)->f.readBlob(image, out);
}

}  // extern "C"
